// Device functions of the single-mover planning kernels E (cycles), F
// (autoreset step) and G (K steps per launch).
//
// Replaces the step bodies of gymnasium_planar_robotics_tpu/ops/pallas_step.py:
// _integrate_mover, _make_wall_checker, _step_kernel's cycle loop and
// _planning_autoreset_step.  Template parameters: kBox (box collision shape:
// three normal pairs per wall check, rotated-rectangle rule; else circle, one
// pair) and kFull (fully populated layout: the closed-form rule; else the
// per-cell table).  Jerk or acceleration actuation is a runtime flag (the
// branch is uniform across the launch).
//
// Arithmetic is the Pallas kernels' expression by expression, each product
// and sum rounded on its own (common.cuh), so the flags and the state agree
// bit for bit with the plain PyTorch versions (ops/kernels/planning.py).
// Up to the wide batch, kernels E, F and G take their noise from producer
// warps that compute it ahead (split.cuh); above it each thread draws its
// env's noise as its cycles run.

#pragma once

#include "common.cuh"
#include "split.cuh"
#include "walls.cuh"

namespace gprt {

// The planning constants struct, passed by value.  Field order is the
// contract with PLANNING_FIELDS in ops/kernels/planning.py, checked at load
// time through gprt_planning_const_names().  wall_x/wall_y: the wall-check
// size during cycles (c + offset_wall: radius in wall_x for the circle,
// half-extents for the box); sample_x/sample_y: the size at reset sampling
// (c + offset + offset_wall).
#define GPRT_PLANNING_FIELDS(X)                                                                  \
  X(v_max) X(a_max) X(dt) X(std_pos) X(std_vel) X(accel_scale) X(wall_x) X(wall_y) X(sample_x) \
  X(sample_y) X(x0) X(x1) X(y0) X(y1) X(has_fast) X(fx0) X(fx1) X(fy0) X(fy1) X(threshold)     \
  X(max_episode_steps) X(min_x) X(min_y) X(span_x) X(span_y)

#define GPRT_DECLARE_FIELD(name) float name;
struct PlanningConsts {
  GPRT_PLANNING_FIELDS(GPRT_DECLARE_FIELD)
};
#undef GPRT_DECLARE_FIELD

// the launch's static description besides the constants
struct PlanningLaunch {
  PlanningConsts c;
  WallTable table;  // holed layouts only
  bool jerk;
  int num_cycles;
  int cand_k;
};

// validity of the collision shape at (px, py) with rotation R (box) or
// radius r (circle), by the layout's rule
template <bool kBox, bool kFull>
__device__ __forceinline__ bool shape_valid(const PlanningLaunch& L, float px, float py, const Rot2& R, float sx,
                                            float sy) {
  if (kBox) {
    return kFull ? box_valid_full(L.c, px, py, R, sx, sy) : box_valid_general(L.table, px, py, R, sx, sy);
  }
  return kFull ? circle_valid_full(L.c, px, py, sx) : circle_valid_general(L.table, px, py, sx);
}

// The per-cycle noisy wall check (_make_wall_checker.check), in two halves:
// wall_pose draws the noise (the position pair; for the box (kBox) also two
// pairs of quaternion noise around the identity, turned into the rotation R
// by quat_to_R2), wall_valid tests the pose.  Neither half reads the state
// but npx, npy, so kernels E, F and G compute wall_pose ahead on the
// producer warps.  Each product and sum is rounded on its own (common.cuh),
// so a pose computed ahead has the bits of one drawn in the cycle.
template <bool kBox, class Noise>
__device__ __forceinline__ void wall_pose(const PlanningConsts& c, Noise& noise, float& nwx, float& nwy, Rot2& R) {
  normal_pair(noise, nwx, nwy);
  if constexpr (kBox) {
    float q1, q2, q3, q4;
    normal_pair(noise, q1, q2);
    normal_pair(noise, q3, q4);
    R = quat_to_R2(madd(1.0f, q1, c.std_pos), mul(q2, c.std_pos), mul(q3, c.std_pos), mul(q4, c.std_pos));
  }
}

// the wall pose popped from values computed ahead (split.cuh, Popped)
template <bool kBox, class Src>
__device__ __forceinline__ void wall_pose(const PlanningConsts&, Popped<Src>& r, float& nwx, float& nwy, Rot2& R) {
  nwx = r.src.pop();
  nwy = r.src.pop();
  if constexpr (kBox) {
    R.r00 = r.src.pop();
    R.r01 = r.src.pop();
    R.r10 = r.src.pop();
    R.r11 = r.src.pop();
  }
}

// True = no wall collision.
template <bool kBox, bool kFull>
__device__ __forceinline__ bool wall_valid(const PlanningLaunch& L, float npx, float npy, float nwx, float nwy,
                                           const Rot2& R) {
  const PlanningConsts& c = L.c;
  return shape_valid<kBox, kFull>(L, madd(npx, nwx, c.std_pos), madd(npy, nwy, c.std_pos), R, c.wall_x, c.wall_y);
}

// reset-time acceptance: identity orientation, the sampling size
template <bool kBox, bool kFull>
__device__ __forceinline__ bool sample_valid_at(const PlanningLaunch& L, float sx, float sy) {
  const Rot2 ident = {1.0f, 0.0f, 0.0f, 1.0f};
  return shape_valid<kBox, kFull>(L, sx, sy, ident, L.c.sample_x, L.c.sample_y);
}

// the mover's planes: position, velocity, control-space acceleration
// (integrator activation in jerk mode, the applied command in acc mode)
struct Mover {
  float px, py, vx, vy, ax, ay;
};

// num_cycles control cycles (_step_kernel / _planning_autoreset_step cycle
// loop): noisy velocity reading, clamp chain, integration at
// qacc = accel_scale * act, noisy wall check, collision latch.  Draws
// (2 + 2p) uniforms per cycle (p = 3 box, 1 circle), also once latched, or
// pops as many values computed ahead (Popped: the velocity pair, the wall
// pair, the box's R).  Returns the wall flag (0 or 1).
template <bool kBox, bool kFull, class Noise>
__device__ float planning_cycles(const PlanningLaunch& L, Noise& noise, Mover& m, float ux, float uy) {
  const PlanningConsts& c = L.c;
  float done_f = 0.0f, wall_f = 0.0f;
  for (int i = 0; i < L.num_cycles; ++i) {
    const bool done = done_f > 0.0f;
    float nvx, nvy;
    normal_pair(noise, nvx, nvy);
    const float vmx = madd(m.vx, nvx, c.std_vel), vmy = madd(m.vy, nvy, c.std_vel);
    // measured acceleration scale * act (dynamics.jerk_cycle); exact at 1
    const float amx = mul(c.accel_scale, m.ax), amy = mul(c.accel_scale, m.ay);
    float nax, nay;
    if (L.jerk) {
      clamp_chain<true>(c.v_max, c.a_max, c.dt, vmx, vmy, ux, uy, amx, amy, m.ax, m.ay, nax, nay);
    } else {
      clamp_chain<false>(c.v_max, c.a_max, c.dt, vmx, vmy, ux, uy, amx, amy, m.ax, m.ay, nax, nay);
    }
    const float nvx_t = madd(m.vx, c.dt, mul(c.accel_scale, nax));
    const float nvy_t = madd(m.vy, c.dt, mul(c.accel_scale, nay));
    const float npx = madd(m.px, c.dt, nvx_t);
    const float npy = madd(m.py, c.dt, nvy_t);
    float nwx, nwy;
    Rot2 R = {1.0f, 0.0f, 0.0f, 1.0f};
    wall_pose<kBox>(c, noise, nwx, nwy, R);
    const float new_wall_f = wall_valid<kBox, kFull>(L, npx, npy, nwx, nwy, R) ? 0.0f : 1.0f;
    if (!done) {
      m.px = npx; m.py = npy; m.vx = nvx_t; m.vy = nvy_t; m.ax = nax; m.ay = nay;
      wall_f = new_wall_f;
    }
    done_f = fmaxf(done_f, wall_f);
  }
  return wall_f;
}

// First accepted of cand_k uniform draws over the sampling box
// (_planning_autoreset_step.sample_valid).  Once a candidate is accepted the
// rest are passed over unread: they change neither the sample nor the trial
// count.  Always consumes 2 * cand_k draws.
template <bool kBox, bool kFull, class Noise>
__device__ __forceinline__ void sample_valid(const PlanningLaunch& L, Noise& noise, float& sx, float& sy, bool& found,
                                             float& trials) {
  const PlanningConsts& c = L.c;
  sx = uniform_in(noise, c.min_x, c.span_x);
  sy = uniform_in(noise, c.min_y, c.span_y);
  found = sample_valid_at<kBox, kFull>(L, sx, sy);
  trials = 1.0f;
  for (int k = 1; k < L.cand_k; ++k) {
    if (found) {
      noise.skip(2 * (L.cand_k - k));
      break;
    }
    const float cx = uniform_in(noise, c.min_x, c.span_x);
    const float cy = uniform_in(noise, c.min_y, c.span_y);
    trials += 1.0f;
    if (sample_valid_at<kBox, kFull>(L, cx, cy)) {
      sx = cx;
      sy = cy;
      found = true;
    }
  }
}

struct PlanningState {
  Mover m;
  float gx, gy, steps;
};

// the 15 per-step outputs besides the state, in the Pallas aux order
struct PlanningAux {
  float s_vx, s_vy, s_agx, s_agy;
  float f_vx, f_vy, f_agx, f_agy, f_ax, f_ay;
  float wall, reached, trunc, stalled, trials;
};

// The state-independent values of one step besides its cycles' draws, by
// index: the pre-reset (n1..n4) and post-reset (m1..m4) observation normals
// and the restart's result, the start (sx, sy) and the goal (gx, gy) with
// each one's found flag (0 or 1) and trial count.
struct PlanStep {
  enum : int { kN1 = 0, kM1 = 4, kSx = 8, kSy, kSFound, kSTrials, kGx, kGy, kGFound, kGTrials, kCount };
};
static_assert(PlanStep::kCount <= kStageValues, "a step stage holds the step's values");

// One autoreset env step (_planning_autoreset_step) of action (ux, uy):
// cycles, pre-reset observation, termination (wall | goal reached within
// the noisy threshold | time limit), restart, post-reset observation.  The
// cycles' draws come from `cycles` (a noise stream, or Popped), the step's
// other values from the source sv: sv.acquire() makes the pre-reset normals
// ready, sv.restart(done) the restart and the post-reset normals, then
// sv(i) (PlanStep) reads them.  A stalled restart (no valid candidate) does
// not restart the env: state and step counter carry over, and done fires
// again next step.
template <bool kBox, bool kFull, class Cycles, class Values>
__device__ __forceinline__ void planning_autoreset_step(const PlanningLaunch& L, Cycles& cycles, Values& sv,
                                                        PlanningState& st, float ux, float uy, PlanningAux& aux) {
  const PlanningConsts& c = L.c;
  Mover& m = st.m;
  const float wall_f = planning_cycles<kBox, kFull>(L, cycles, m, ux, uy);
  aux.f_ax = m.ax;  // pre-reset acceleration (jerk-mode final observation)
  aux.f_ay = m.ay;

  sv.acquire();
  aux.f_agx = madd(m.px, sv(PlanStep::kN1 + 0), c.std_pos);
  aux.f_agy = madd(m.py, sv(PlanStep::kN1 + 1), c.std_pos);
  aux.f_vx = madd(m.vx, sv(PlanStep::kN1 + 2), c.std_vel);
  aux.f_vy = madd(m.vy, sv(PlanStep::kN1 + 3), c.std_vel);
  const float ddx = sub(aux.f_agx, st.gx), ddy = sub(aux.f_agy, st.gy);
  const bool reached = sqrtf(sq2(ddx, ddy)) <= c.threshold;
  const bool term = (wall_f > 0.0f) | reached;
  const float new_steps = add(st.steps, 1.0f);
  const bool trunc = new_steps >= c.max_episode_steps;
  const bool done = term | trunc;

  sv.restart(done);
  const bool found = (sv(PlanStep::kSFound) > 0.0f) & (sv(PlanStep::kGFound) > 0.0f);
  aux.stalled = (done & !found) ? 1.0f : 0.0f;
  const bool do_reset = done & found;
  if (do_reset) {
    m.px = sv(PlanStep::kSx); m.py = sv(PlanStep::kSy); m.vx = 0.0f; m.vy = 0.0f; m.ax = 0.0f; m.ay = 0.0f;
    st.gx = sv(PlanStep::kGx); st.gy = sv(PlanStep::kGy); st.steps = 0.0f;
  } else {
    st.steps = new_steps;
  }

  aux.s_agx = do_reset ? madd(m.px, sv(PlanStep::kM1 + 0), c.std_pos) : aux.f_agx;
  aux.s_agy = do_reset ? madd(m.py, sv(PlanStep::kM1 + 1), c.std_pos) : aux.f_agy;
  aux.s_vx = do_reset ? madd(m.vx, sv(PlanStep::kM1 + 2), c.std_vel) : aux.f_vx;
  aux.s_vy = do_reset ? madd(m.vy, sv(PlanStep::kM1 + 3), c.std_vel) : aux.f_vy;

  aux.wall = wall_f;
  aux.reached = reached ? 1.0f : 0.0f;
  aux.trunc = trunc ? 1.0f : 0.0f;
  aux.trials = done ? add(sv(PlanStep::kSTrials), sv(PlanStep::kGTrials)) : 0.0f;
}

// The step's values drawn in order from the env's own stream, where the
// cycles left it (the thread-per-env arithmetic, for kernel F and G's blocks
// without the producer): the pre-reset pairs, then the two first-accepted
// samplers if the env is done (a sampler stops checking at its first
// accepted candidate), else the 4 * cand_k sampling draws passed over
// unread, then the post-reset pairs.
template <bool kBox, bool kFull, class Noise>
struct InlineStep {
  const PlanningLaunch& L;
  Noise& noise;
  float v[PlanStep::kCount];
  __device__ __forceinline__ void acquire() {
    normal_pair(noise, v[PlanStep::kN1 + 0], v[PlanStep::kN1 + 1]);
    normal_pair(noise, v[PlanStep::kN1 + 2], v[PlanStep::kN1 + 3]);
  }
  __device__ __forceinline__ void restart(bool done) {
    bool s_found = false, g_found = false;
    v[PlanStep::kSx] = v[PlanStep::kSy] = v[PlanStep::kGx] = v[PlanStep::kGy] = 0.0f;
    v[PlanStep::kSTrials] = v[PlanStep::kGTrials] = 0.0f;
    if (done) {
      sample_valid<kBox, kFull>(L, noise, v[PlanStep::kSx], v[PlanStep::kSy], s_found, v[PlanStep::kSTrials]);
      sample_valid<kBox, kFull>(L, noise, v[PlanStep::kGx], v[PlanStep::kGy], g_found, v[PlanStep::kGTrials]);
    } else {
      noise.skip(4 * L.cand_k);
    }
    v[PlanStep::kSFound] = s_found ? 1.0f : 0.0f;
    v[PlanStep::kGFound] = g_found ? 1.0f : 0.0f;
    normal_pair(noise, v[PlanStep::kM1 + 0], v[PlanStep::kM1 + 1]);
    normal_pair(noise, v[PlanStep::kM1 + 2], v[PlanStep::kM1 + 3]);
  }
  __device__ __forceinline__ float operator()(int i) const { return v[i]; }
};

// The step's values from the ring (RingReader): computed ahead for every
// env, done or not, so restart() has nothing left to do.
template <bool kBox>
struct RingStep {
  RingReader<kBox>& ring;
  __device__ __forceinline__ void acquire() { ring.acquire(); }
  __device__ __forceinline__ void restart(bool) {}
  __device__ __forceinline__ float operator()(int i) const { return ring(i); }
};

// plane I/O: the 9 state planes (pos, vel, act x/y, goal x/y, steps)
__device__ __forceinline__ void load_planning_state(const float* in, int64_t B, int64_t e, PlanningState& st) {
  st.m.px = in[0 * B + e]; st.m.py = in[1 * B + e]; st.m.vx = in[2 * B + e]; st.m.vy = in[3 * B + e];
  st.m.ax = in[4 * B + e]; st.m.ay = in[5 * B + e];
  st.gx = in[6 * B + e]; st.gy = in[7 * B + e]; st.steps = in[8 * B + e];
}

__device__ __forceinline__ void store_planning_state(float* out, int64_t B, int64_t e, const PlanningState& st) {
  out[0 * B + e] = st.m.px; out[1 * B + e] = st.m.py; out[2 * B + e] = st.m.vx; out[3 * B + e] = st.m.vy;
  out[4 * B + e] = st.m.ax; out[5 * B + e] = st.m.ay;
  out[6 * B + e] = st.gx; out[7 * B + e] = st.gy; out[8 * B + e] = st.steps;
}

// ---------------------------------------------------------------------------
// kernels E, F and G on Hopper: warp-specialised producer/consumer blocks
// (split.cuh).  Warp 0, the consumer, runs the dependent chain from
// registers: per cycle the clamp chain, the integration, the wall validity
// of the noisy pose and the latch; for F and G per step the termination, the
// restart select and the two observations (planning_autoreset_step),
// reading each step's action one step ahead.  The producer warps (several:
// one computes more per cycle than the consumer) compute per cycle the
// velocity pair and the wall pose (the box: R) and, for F and G, per step
// the observation normals and the restart (PlanStep), for every env whether
// or not it is done.  Every offset of a step's draws is a multiple of 4
// (n_step = (2 + 2p) * num_cycles, + 8 + 4 * cand_k for an autoreset step),
// so a cycle's draws are one Philox block (two for the box).  Without the
// producer (the wide batch) each thread runs its env's step on the
// thread-per-env arithmetic (InlineStep), in blocks of kInlineWarps warps.
// ---------------------------------------------------------------------------

// Producer: n cycles of one step of env `env` (draws from d0) into v.
template <bool kBox, class Src>
__device__ __forceinline__ void produce_cycles(float (*v)[32], const PlanningConsts& c, const Src& src, int64_t env,
                                               uint32_t d0, int n, int lane) {
  for (int i = 0; i < n; ++i) {
    const uint32_t d = d0 + static_cast<uint32_t>(i * cycle_values<kBox>());
    float(*o)[32] = v + i * cycle_values<kBox>();
    const float4 u = src.block4(env, d);
    box_muller(u.x, u.y, o[0][lane], o[1][lane]);
    box_muller(u.z, u.w, o[2][lane], o[3][lane]);
    if constexpr (kBox) {
      const float4 w = src.block4(env, d + 4u);
      float q1, q2, q3, q4;
      box_muller(w.x, w.y, q1, q2);
      box_muller(w.z, w.w, q3, q4);
      const Rot2 R =
          quat_to_R2(madd(1.0f, q1, c.std_pos), mul(q2, c.std_pos), mul(q3, c.std_pos), mul(q4, c.std_pos));
      o[4][lane] = R.r00;
      o[5][lane] = R.r01;
      o[6][lane] = R.r10;
      o[7][lane] = R.r11;
    }
  }
}

// Producer: one first-accepted sampler (sample_valid; candidate j of env e
// is draws d0 + 2j, d0 + 2j + 1 of e's stream) of lane's env into v[x .. x +
// 3] (x, y, found, trials).  Each lane walks its own env's candidates: the
// warp runs as many as its slowest lane needs.
template <bool kBox, bool kFull, class Src>
__device__ __forceinline__ void produce_sampler(float (*v)[32], const PlanningLaunch& L, const Src& src, int64_t env,
                                                uint32_t d0, int x, int lane) {
  auto noise = src.at(env, d0);
  float sx, sy, trials;
  bool found;
  sample_valid<kBox, kFull>(L, noise, sx, sy, found, trials);
  v[x + 0][lane] = sx;
  v[x + 1][lane] = sy;
  v[x + 2][lane] = found ? 1.0f : 0.0f;
  v[x + 3][lane] = trials;
}

// Producer: the step stage of a tile (d_obs: the step's first draw after its
// cycles): the four pre-reset normals, the start and goal samplers, the four
// post-reset normals.
template <bool kBox, bool kFull, class Src>
__device__ void produce_step(float (*v)[32], const PlanningLaunch& L, const Src& src, int64_t B, int64_t tile,
                             uint32_t d_obs, int lane) {
  const int64_t e = tile * 32 + lane;
  const int64_t er = e < B ? e : B - 1;  // tail lanes draw a real env's values
  const uint32_t d_start = d_obs + 4u, d_goal = d_start + 2u * static_cast<uint32_t>(L.cand_k);
  const float4 n = src.block4(er, d_obs);
  box_muller(n.x, n.y, v[PlanStep::kN1 + 0][lane], v[PlanStep::kN1 + 1][lane]);
  box_muller(n.z, n.w, v[PlanStep::kN1 + 2][lane], v[PlanStep::kN1 + 3][lane]);
  const float4 m = src.block4(er, d_goal + 2u * static_cast<uint32_t>(L.cand_k));
  box_muller(m.x, m.y, v[PlanStep::kM1 + 0][lane], v[PlanStep::kM1 + 1][lane]);
  box_muller(m.z, m.w, v[PlanStep::kM1 + 2][lane], v[PlanStep::kM1 + 3][lane]);
  produce_sampler<kBox, kFull>(v, L, src, er, d_start, PlanStep::kSx, lane);
  produce_sampler<kBox, kFull>(v, L, src, er, d_goal, PlanStep::kGx, lane);
}

// K steps of one env: step(ux, uy, st, aux) runs a step, each step's action
// read one step ahead; where `valid`, Io reads the env's state (load(e, st))
// and receives each step's result (step(e, t, st, aux)) and the final state
// (finish(e, st)).
template <class Io, class Step>
__device__ __forceinline__ void consume_steps(const float* __restrict__ actions, int64_t B, int K, int64_t e,
                                              bool valid, Io& io, Step&& step) {
  PlanningState st{};
  float ux = 0.0f, uy = 0.0f;
  if (valid) {
    io.load(e, st);
    ux = actions[e];
    uy = actions[B + e];
  }
  for (int t = 0; t < K; ++t) {
    float next_ux = 0.0f, next_uy = 0.0f;
    if (valid && t + 1 < K) {
      next_ux = actions[(2 * static_cast<int64_t>(t + 1)) * B + e];
      next_uy = actions[(2 * static_cast<int64_t>(t + 1) + 1) * B + e];
    }
    PlanningAux aux;
    step(ux, uy, st, aux);
    if (valid) io.step(e, t, st, aux);
    ux = next_ux;
    uy = next_uy;
  }
  if (valid) io.finish(e, st);
}

// planning_cycles compiled on its own, called out of line.  Kernel E's
// consumer takes it for the box on a holed layout: inlined there, beside
// the producer warps' code, the box's table walk ran 1.5x slower than the
// thread-per-env kernel's; out of line, 10% faster (PERF.md section 6).
template <bool kBox, bool kFull, class Cycles>
__device__ __noinline__ float planning_cycles_call(const PlanningLaunch& L, Cycles& cycles, Mover& m, float ux,
                                                   float uy) {
  return planning_cycles<kBox, kFull>(L, cycles, m, ux, uy);
}

// One step of the consumer: the cycles' draws from `cycles`, an autoreset
// step's other values from sv (kSteps, split.cuh); kernel E's step is its
// cycles alone, with the wall flag in aux.wall, called out of line where
// kOutOfLine.
template <bool kBox, bool kFull, Steps kSteps, bool kOutOfLine, class Cycles, class Values>
__device__ __forceinline__ void consume_step(const PlanningLaunch& L, Cycles& cycles, Values& sv, PlanningState& st,
                                             float ux, float uy, PlanningAux& aux) {
  if constexpr (kSteps == Steps::kAutoreset) {
    planning_autoreset_step<kBox, kFull>(L, cycles, sv, st, ux, uy, aux);
  } else if constexpr (kOutOfLine) {
    aux.wall = planning_cycles_call<kBox, kFull>(L, cycles, st.m, ux, uy);
  } else {
    aux.wall = planning_cycles<kBox, kFull>(L, cycles, st.m, ux, uy);
  }
}

// Producer warps of a block with the producer.  One producer warp's draws
// take ~8x the consumer's chain a control cycle, so one would bound it; the
// count divides kRingSlots, so that each slot has one producer.
constexpr int kPlanningProducers = 2;
static_assert(kRingSlots % kPlanningProducers == 0, "each ring slot needs a single producer");
// threads of the largest block of kernels E, F and G
constexpr int kPlanningSplitWarps = 1 + kPlanningProducers;
constexpr int kPlanningMaxThreads = 32 * (kPlanningSplitWarps > kInlineWarps ? kPlanningSplitWarps : kInlineWarps);

// The body of kernels E, F and G: K steps of this block's envs (kSteps: a
// step with or without its step stage), with the producer (kProducer: a
// block of the consumer warp and kPlanningProducers producer warps, one
// tile) or without (a block of kInlineWarps warps, one thread an env).
template <bool kBox, bool kFull, bool kProducer, Steps kSteps, class Src, class Io>
__device__ __forceinline__ void planning_body(const PlanningLaunch& L, const Src& src,
                                              const float* __restrict__ actions, int64_t B, int K, Io& io) {
  constexpr bool kStepStage = kSteps == Steps::kAutoreset;
  if constexpr (!kProducer) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= B) return;
    // one stream per env, on across the K steps
    auto noise = src.at(e, 0);
    consume_steps(actions, B, K, e, true, io, [&](float ux, float uy, PlanningState& st, PlanningAux& aux) {
      InlineStep<kBox, kFull, decltype(noise)> sv{L, noise};
      consume_step<kBox, kFull, kSteps, false>(L, noise, sv, st, ux, uy, aux);
    });
  } else {
    const int warp = static_cast<int>(threadIdx.x >> 5), lane = static_cast<int>(threadIdx.x & 31);
    const int64_t tile = blockIdx.x;
    extern __shared__ __align__(16) unsigned char split_shared[];
    SplitShared& sh = *reinterpret_cast<SplitShared*>(split_shared);
    if (threadIdx.x == 0) {
      for (int i = 0; i < kRingSlots; ++i) {
        mbar_init(&sh.full[i], 32);
        mbar_init(&sh.empty[i], 32);
      }
    }
    __syncthreads();
    const int64_t e = tile * 32 + lane;
    if (warp == 0) {
      // consumer
      Popped<RingReader<kBox>> cycles{RingReader<kBox>{&sh, lane}};
      RingStep<kBox> sv{cycles.src};
      consume_steps(actions, B, K, e, e < B, io, [&](float ux, float uy, PlanningState& st, PlanningAux& aux) {
        cycles.src.begin_step(L.num_cycles);
        consume_step<kBox, kFull, kSteps, !kStepStage && kBox && !kFull>(L, cycles, sv, st, ux, uy, aux);
      });
    } else {
      // producer warp w (1 .. P): stages k = w - 1, w - 1 + P, ... of the
      // tile's K * stages, so that stage k's slot k % kRingSlots always has
      // the same producer
      const int q = cycle_values<kBox>(), per = stage_cycles<kBox>();
      const int cyc_stages = (L.num_cycles + per - 1) / per, stages = cyc_stages + (kStepStage ? 1 : 0);
      const uint32_t d_obs = static_cast<uint32_t>(q * L.num_cycles);
      const uint32_t n_step = d_obs + (kStepStage ? 8u + 4u * static_cast<uint32_t>(L.cand_k) : 0u);
      const int64_t er = e < B ? e : B - 1;  // tail lanes draw a real env's values
      const uint32_t n_stages = static_cast<uint32_t>(K) * static_cast<uint32_t>(stages);
      for (uint32_t k = static_cast<uint32_t>(warp - 1); k < n_stages; k += kPlanningProducers) {
        const int j = static_cast<int>(k % static_cast<uint32_t>(stages));
        const uint32_t d_step = k / static_cast<uint32_t>(stages) * n_step;
        const RingPos r = ring_pos(k);
        mbar_wait(&sh.empty[r.slot], r.parity ^ 1u);
        if (kStepStage && j == cyc_stages) {
          produce_step<kBox, kFull>(sh.stage[r.slot], L, src, B, tile, d_step + d_obs, lane);
        } else {
          const int i0 = j * per, n = L.num_cycles - i0 < per ? L.num_cycles - i0 : per;
          produce_cycles<kBox>(sh.stage[r.slot], L.c, src, er, d_step + static_cast<uint32_t>(i0 * q), n, lane);
        }
        mbar_arrive(&sh.full[r.slot]);
      }
    }
  }
}

// Host side: launch `kernel` over B envs in blocks with the producer, or
// without (thread-per-env blocks).
template <class Kernel, class... Args>
void launch_planning(Kernel kernel, bool producer, int64_t B, cudaStream_t s, Args... args) {
  const int warps = producer ? kPlanningProducers : 0;
  kernel<<<split_blocks(warps, B), split_threads(warps), split_shared_bytes(warps), s>>>(args...);
}

// Host side: instantiate Body<kBox, kFull, kInject>::launch(args...) for the
// runtime flags.
template <template <bool, bool, bool> class Body, class... Args>
void dispatch_planning(bool box, bool full, bool inject, Args&&... args) {
  if (box) {
    if (full) {
      inject ? Body<true, true, true>::launch(args...) : Body<true, true, false>::launch(args...);
    } else {
      inject ? Body<true, false, true>::launch(args...) : Body<true, false, false>::launch(args...);
    }
  } else {
    if (full) {
      inject ? Body<false, true, true>::launch(args...) : Body<false, true, false>::launch(args...);
    } else {
      inject ? Body<false, false, true>::launch(args...) : Body<false, false, false>::launch(args...);
    }
  }
}

// the launch description from the C interface's arguments
inline PlanningLaunch make_planning_launch(const void* consts, const float* table, int n_cells, int jerk,
                                           int num_cycles, int cand_k) {
  PlanningLaunch L;
  L.c = *static_cast<const PlanningConsts*>(consts);
  L.table.p = table;
  L.table.n_cells = n_cells;
  L.jerk = jerk != 0;
  L.num_cycles = num_cycles;
  L.cand_k = cand_k;
  return L;
}

}  // namespace gprt
