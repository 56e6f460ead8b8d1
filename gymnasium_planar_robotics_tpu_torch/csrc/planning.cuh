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

#pragma once

#include "common.cuh"
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

// The per-cycle noisy wall check (_make_wall_checker.check): position noise
// (one pair), for the box also quaternion noise (two pairs) around the
// identity.  True = no wall collision.
template <bool kBox, bool kFull, class Noise>
__device__ __forceinline__ bool wall_check(const PlanningLaunch& L, Noise& noise, float px, float py) {
  const PlanningConsts& c = L.c;
  float nx, ny;
  normal_pair(noise, nx, ny);
  const float wx = madd(px, nx, c.std_pos), wy = madd(py, ny, c.std_pos);
  Rot2 R = {1.0f, 0.0f, 0.0f, 1.0f};
  if (kBox) {
    float q1, q2, q3, q4;
    normal_pair(noise, q1, q2);
    normal_pair(noise, q3, q4);
    R = quat_to_R2(madd(1.0f, q1, c.std_pos), mul(q2, c.std_pos), mul(q3, c.std_pos), mul(q4, c.std_pos));
  }
  return shape_valid<kBox, kFull>(L, wx, wy, R, c.wall_x, c.wall_y);
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
// (2 + 2p) uniforms per cycle (p = 3 box, 1 circle), also once latched.
// Returns the wall flag (0 or 1).
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
    const float new_wall_f = wall_check<kBox, kFull>(L, noise, npx, npy) ? 0.0f : 1.0f;
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

// One autoreset env step (_planning_autoreset_step): cycles, pre-reset
// observation (2 pairs), termination (wall | goal reached within the noisy
// threshold | time limit), start and goal resampling (cand_k candidates
// each), post-reset observation (2 pairs).  Consumes
// (2 + 2p) * num_cycles + 8 + 4 * cand_k draws.  An env that is not done
// passes over the 4 * cand_k sampling draws unread: its restart is not used.
template <bool kBox, bool kFull, class Noise>
__device__ void planning_autoreset_step(const PlanningLaunch& L, Noise& noise, PlanningState& st, float ux, float uy,
                                        PlanningAux& aux) {
  const PlanningConsts& c = L.c;
  Mover& m = st.m;
  const float wall_f = planning_cycles<kBox, kFull>(L, noise, m, ux, uy);
  aux.f_ax = m.ax;  // pre-reset acceleration (jerk-mode final observation)
  aux.f_ay = m.ay;

  float n1, n2, n3, n4;
  normal_pair(noise, n1, n2);
  normal_pair(noise, n3, n4);
  aux.f_agx = madd(m.px, n1, c.std_pos);
  aux.f_agy = madd(m.py, n2, c.std_pos);
  aux.f_vx = madd(m.vx, n3, c.std_vel);
  aux.f_vy = madd(m.vy, n4, c.std_vel);
  const float ddx = sub(aux.f_agx, st.gx), ddy = sub(aux.f_agy, st.gy);
  const bool reached = sqrtf(sq2(ddx, ddy)) <= c.threshold;
  const bool term = (wall_f > 0.0f) | reached;
  const float new_steps = add(st.steps, 1.0f);
  const bool trunc = new_steps >= c.max_episode_steps;
  const bool done = term | trunc;

  float rsx = 0.0f, rsy = 0.0f, rgx = 0.0f, rgy = 0.0f, s_trials = 0.0f, g_trials = 0.0f;
  bool s_found = false, g_found = false;
  if (done) {
    sample_valid<kBox, kFull>(L, noise, rsx, rsy, s_found, s_trials);
    sample_valid<kBox, kFull>(L, noise, rgx, rgy, g_found, g_trials);
  } else {
    noise.skip(4 * L.cand_k);
  }
  // a stalled draw (no valid candidate) does not restart the env: state and
  // step counter carry over, done fires again next step
  const bool found = s_found & g_found;
  aux.stalled = (done & !found) ? 1.0f : 0.0f;
  const bool do_reset = done & found;
  if (do_reset) {
    m.px = rsx; m.py = rsy; m.vx = 0.0f; m.vy = 0.0f; m.ax = 0.0f; m.ay = 0.0f;
    st.gx = rgx; st.gy = rgy; st.steps = 0.0f;
  } else {
    st.steps = new_steps;
  }

  float m1, m2, m3, m4;
  normal_pair(noise, m1, m2);
  normal_pair(noise, m3, m4);
  aux.s_agx = do_reset ? madd(m.px, m1, c.std_pos) : aux.f_agx;
  aux.s_agy = do_reset ? madd(m.py, m2, c.std_pos) : aux.f_agy;
  aux.s_vx = do_reset ? madd(m.vx, m3, c.std_vel) : aux.f_vx;
  aux.s_vy = do_reset ? madd(m.vy, m4, c.std_vel) : aux.f_vy;

  aux.wall = wall_f;
  aux.reached = reached ? 1.0f : 0.0f;
  aux.trunc = trunc ? 1.0f : 0.0f;
  aux.trials = done ? add(s_trials, g_trials) : 0.0f;
}

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
