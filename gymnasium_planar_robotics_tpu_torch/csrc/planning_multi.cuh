// Kernel H: one M-mover planning autoreset env step (device functions and
// the launcher template; the instantiations live in
// planning_multi_m<M>_<shape>.cu).
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_multi_autoreset_kernel, reached from
// make_fused_planning_multi_autoreset_cycles.
//
// Per cycle, in the Pallas kernel's order: every mover's noisy velocity
// reading, clamp chain and integration at qacc = accel_scale[i] * act; then
// every mover's noisy wall check (its own pose noise and size); then a second,
// independent noisy pose for every mover and the test of all M(M-1)/2 pairs
// (circle: centre distance against the summed radii; box: four-axis SAT
// minus strict containment on the quaternion-noised rotations); then the
// shared-fate latch (once any mover hits a wall or another mover the whole
// state freezes).  After the cycles: the pre-reset observation, the count of
// unreached goals, termination, joint start-set and goal-set sampling
// (cand_k candidate sets of M positions, first accepted), the stalled rule
// and the post-reset observation.
//
// Bound on an H100: arithmetic and latency per env.  At M = 4, circle,
// 40 cycles the step draws 1,248 uniforms and runs 160 clamp chains, 160
// wall checks and 240 pair tests; the state is 33 planes in and 78 out
// (0.45 KB per env).  Design: one thread per env; M, the collision shape,
// the layout rule and the noise mode are template parameters, so every
// mover and pair loop unrolls and the positions, velocities, actions and
// noisy poses stay in registers; per-mover sizes and the per-pair sums the
// Pallas kernel forms in float64 come in a by-value constants struct.  As in
// kernel F, an env that is not done passes over the sampling draws unread
// and a sampler stops testing at its first accepted set (skip() keeps the
// Philox stream in place).
//
// Every product and sum is rounded on its own (common.cuh), as the plain
// PyTorch version's eager ops do (ops/kernels/planning_multi.py), so the two
// agree bit for bit.

#pragma once

#include "planning.cuh"

namespace gprt {

constexpr int kMaxMovers = 8;
constexpr int kMaxPairs = kMaxMovers * (kMaxMovers - 1) / 2;

// The per-mover and per-pair constants, passed by value beside
// PlanningConsts.  Field order (name, length) is the contract with
// MULTI_FIELDS in ops/kernels/planning_multi.py, checked at load time through
// gprt_multi_const_names().  Sizes are radii (circle: *_x, *_y equal) or
// half-extents (box): c_wall = c + offset_wall (cycle wall check), c_sample =
// c + offset + offset_wall (reset wall check), c_sample_pair = c + offset
// (reset pair test), c_pair = c (cycle pair test).  pair_sum (circle) and
// sample_pair_sum_x/_y are the summed sizes of pair p (pairs (i, j), i < j,
// in row order), formed in float64 and rounded once.
#define GPRT_MULTI_FIELDS(X)                                                                               \
  X(c_wall_x, 8) X(c_wall_y, 8) X(c_sample_x, 8) X(c_sample_y, 8) X(c_sample_pair_x, 8) X(c_sample_pair_y, 8) \
  X(c_pair_x, 8) X(c_pair_y, 8) X(accel_scale, 8) X(pair_sum, 28) X(sample_pair_sum_x, 28)                 \
  X(sample_pair_sum_y, 28) X(min_goal_dist, 1)

#define GPRT_DECLARE_ARRAY(name, n) float name[n];
struct MultiConsts {
  GPRT_MULTI_FIELDS(GPRT_DECLARE_ARRAY)
};
#undef GPRT_DECLARE_ARRAY
static_assert(kMaxMovers == 8 && kMaxPairs == 28, "the lengths in GPRT_MULTI_FIELDS");

// The holed layouts' per-cell rule as one call: one copy per instantiation
// instead of 3M inlined ones (M wall checks per cycle, M per start and per
// goal candidate set), which keeps the build of the 56 instantiations short.
// Full layouts keep the inlined closed form.
template <bool kBox>
__device__ __noinline__ bool holed_valid(const WallTable& t, float px, float py, Rot2 R, float sx, float sy) {
  return kBox ? box_valid_general(t, px, py, R, sx, sy) : circle_valid_general(t, px, py, sx);
}

template <bool kBox, bool kFull>
__device__ __forceinline__ bool multi_shape_valid(const PlanningLaunch& L, float px, float py, const Rot2& R, float sx,
                                                  float sy) {
  if (kFull) return shape_valid<kBox, true>(L, px, py, R, sx, sy);
  return holed_valid<kBox>(L.table, px, py, R, sx, sy);
}

// quaternion noise around the identity (two normal pairs) -> 2D rotation
template <class Noise>
__device__ __forceinline__ Rot2 noisy_rotation(Noise& noise, float std_pos) {
  float q1, q2, q3, q4;
  normal_pair(noise, q1, q2);
  normal_pair(noise, q3, q4);
  return quat_to_R2(madd(1.0f, q1, std_pos), mul(q2, std_pos), mul(q3, std_pos), mul(q4, std_pos));
}

// Rotated rectangles a and b (centre offset (tx, ty) = b - a) collide: the
// four-axis SAT overlap (touching counts) minus strict containment of either
// in the other (rects_intersect_sat in the Pallas kernel).
__device__ __forceinline__ bool rects_intersect_sat(float tx, float ty, const Rot2& Ra, float hax, float hay,
                                                    const Rot2& Rb, float hbx, float hby) {
  const float d00 = fabsf(add(mul(Ra.r00, Rb.r00), mul(Ra.r10, Rb.r10)));
  const float d01 = fabsf(add(mul(Ra.r00, Rb.r01), mul(Ra.r10, Rb.r11)));
  const float d10 = fabsf(add(mul(Ra.r01, Rb.r00), mul(Ra.r11, Rb.r10)));
  const float d11 = fabsf(add(mul(Ra.r01, Rb.r01), mul(Ra.r11, Rb.r11)));
  const float ta1 = fabsf(add(mul(tx, Ra.r00), mul(ty, Ra.r10)));
  const float ta2 = fabsf(add(mul(tx, Ra.r01), mul(ty, Ra.r11)));
  const float rb1 = add(mul(hbx, d00), mul(hby, d01));
  const float rb2 = add(mul(hbx, d10), mul(hby, d11));
  const float tb1 = fabsf(add(mul(tx, Rb.r00), mul(ty, Rb.r10)));
  const float tb2 = fabsf(add(mul(tx, Rb.r01), mul(ty, Rb.r11)));
  const float ra1 = add(mul(hax, d00), mul(hay, d10));
  const float ra2 = add(mul(hax, d01), mul(hay, d11));
  const bool overlap =
      (ta1 <= add(hax, rb1)) & (ta2 <= add(hay, rb2)) & (tb1 <= add(hbx, ra1)) & (tb2 <= add(hby, ra2));
  const bool b_in_a = (add(ta1, rb1) < hax) & (add(ta2, rb2) < hay);
  const bool a_in_b = (add(tb1, ra1) < hbx) & (add(tb2, ra2) < hby);
  return overlap & !(b_in_a | a_in_b);
}

// The same test at the identity orientation (the restart's start sets): the
// Pallas kernel forms the summed half-extents in float64 there (sum_x, sum_y)
__device__ __forceinline__ bool rects_intersect_ident(float tx, float ty, float hax, float hay, float hbx, float hby,
                                                      float sum_x, float sum_y) {
  const float ax = fabsf(tx), ay = fabsf(ty);
  const bool overlap = (ax <= sum_x) & (ay <= sum_y);
  const bool b_in_a = (add(ax, hbx) < hax) & (add(ay, hby) < hay);
  const bool a_in_b = (add(ax, hax) < hbx) & (add(ay, hay) < hby);
  return overlap & !(b_in_a | a_in_b);
}

// the movers' planes: positions, velocities, control-space accelerations
// (integrator activation in jerk mode, applied command in acc mode), goals,
// each mover-major then x/y
template <int M>
struct MultiState {
  float P[2 * M], V[2 * M], A[2 * M], G[2 * M];
  float steps;
};

// num_cycles control cycles of all M movers with the shared-fate latch.
// Draws (2 + 4p) * M uniforms per cycle (p = 3 box, 1 circle), also once
// latched.  Returns the wall and mover flags (0 or 1).
template <int M, bool kBox, bool kFull, class Noise>
__device__ __forceinline__ void multi_cycles(const PlanningLaunch& L, const MultiConsts& mc, Noise& noise,
                                             MultiState<M>& s, const float (&U)[2 * M], float& wall_f,
                                             float& mover_f) {
  const PlanningConsts& c = L.c;
  float done_f = 0.0f;
  wall_f = 0.0f;
  mover_f = 0.0f;
  for (int cyc = 0; cyc < L.num_cycles; ++cyc) {
    const bool done = done_f > 0.0f;
    float nP[2 * M], nV[2 * M], nA[2 * M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float nvx, nvy;
      normal_pair(noise, nvx, nvy);
      const float vmx = madd(s.V[2 * i], nvx, c.std_vel), vmy = madd(s.V[2 * i + 1], nvy, c.std_vel);
      const float scale = mc.accel_scale[i];
      const float amx = mul(scale, s.A[2 * i]), amy = mul(scale, s.A[2 * i + 1]);
      if (L.jerk) {
        clamp_chain<true>(c.v_max, c.a_max, c.dt, vmx, vmy, U[2 * i], U[2 * i + 1], amx, amy, s.A[2 * i],
                          s.A[2 * i + 1], nA[2 * i], nA[2 * i + 1]);
      } else {
        clamp_chain<false>(c.v_max, c.a_max, c.dt, vmx, vmy, U[2 * i], U[2 * i + 1], amx, amy, s.A[2 * i],
                           s.A[2 * i + 1], nA[2 * i], nA[2 * i + 1]);
      }
      nV[2 * i] = madd(s.V[2 * i], c.dt, mul(scale, nA[2 * i]));
      nV[2 * i + 1] = madd(s.V[2 * i + 1], c.dt, mul(scale, nA[2 * i + 1]));
      nP[2 * i] = madd(s.P[2 * i], c.dt, nV[2 * i]);
      nP[2 * i + 1] = madd(s.P[2 * i + 1], c.dt, nV[2 * i + 1]);
    }
    // every mover's wall check on its own pose noise and size
    bool new_wall = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float wx, wy;
      normal_pair(noise, wx, wy);
      Rot2 R = {1.0f, 0.0f, 0.0f, 1.0f};
      if (kBox) R = noisy_rotation(noise, c.std_pos);
      new_wall |= !multi_shape_valid<kBox, kFull>(L, madd(nP[2 * i], wx, c.std_pos),
                                                  madd(nP[2 * i + 1], wy, c.std_pos), R, mc.c_wall_x[i],
                                                  mc.c_wall_y[i]);
    }
    // a second, independent noisy pose of every mover, then all pairs
    float mx[M], my[M];
    Rot2 mr[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float cx, cy;
      normal_pair(noise, cx, cy);
      mx[i] = madd(nP[2 * i], cx, c.std_pos);
      my[i] = madd(nP[2 * i + 1], cy, c.std_pos);
      if (kBox) mr[i] = noisy_rotation(noise, c.std_pos);
    }
    bool new_mover = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i + 1; j < M; ++j) {
        if (kBox) {
          new_mover |= rects_intersect_sat(sub(mx[j], mx[i]), sub(my[j], my[i]), mr[i], mc.c_pair_x[i],
                                           mc.c_pair_y[i], mr[j], mc.c_pair_x[j], mc.c_pair_y[j]);
        } else {
          const int p = i * (2 * M - i - 1) / 2 + (j - i - 1);
          new_mover |= sqrtf(sq2(sub(mx[i], mx[j]), sub(my[i], my[j]))) <= mc.pair_sum[p];
        }
      }
    }
    if (!done) {
#pragma unroll
      for (int k = 0; k < 2 * M; ++k) {
        s.P[k] = nP[k];
        s.V[k] = nV[k];
        s.A[k] = nA[k];
      }
      wall_f = new_wall ? 1.0f : 0.0f;
      mover_f = new_mover ? 1.0f : 0.0f;
    }
    done_f = fmaxf(done_f, fmaxf(wall_f, mover_f));
  }
}

// First accepted of cand_k candidate sets of M positions (sample_set in the
// Pallas kernel): every mover wall-valid at the identity orientation with its
// sampling size, and every pair apart (start sets: no collision at the summed
// sizes with the safety offset; goal sets: distance >= min_goal_dist).  Once
// a set is accepted the rest are passed over unread: they change neither the
// sample nor the trial count.  Always consumes 2 * M * cand_k draws.
template <int M, bool kBox, bool kFull, bool kGoal, class Noise>
__device__ __forceinline__ void sample_set(const PlanningLaunch& L, const MultiConsts& mc, Noise& noise,
                                           float (&best)[2 * M], bool& found, float& trials) {
  const PlanningConsts& c = L.c;
  const Rot2 ident = {1.0f, 0.0f, 0.0f, 1.0f};
  found = false;
  trials = 0.0f;
  for (int k = 0; k < L.cand_k; ++k) {
    if (found) {
      noise.skip(2 * M * (L.cand_k - k));
      break;
    }
    trials = add(trials, 1.0f);
    float cand[2 * M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      cand[2 * i] = uniform_in(noise, c.min_x, c.span_x);
      cand[2 * i + 1] = uniform_in(noise, c.min_y, c.span_y);
    }
    bool ok = true;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ok &= multi_shape_valid<kBox, kFull>(L, cand[2 * i], cand[2 * i + 1], ident, mc.c_sample_x[i],
                                           mc.c_sample_y[i]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i + 1; j < M; ++j) {
        const int p = i * (2 * M - i - 1) / 2 + (j - i - 1);
        const float dx = sub(cand[2 * i], cand[2 * j]), dy = sub(cand[2 * i + 1], cand[2 * j + 1]);
        if (kGoal) {
          ok &= sqrtf(sq2(dx, dy)) >= mc.min_goal_dist[0];
        } else if (kBox) {
          ok &= !rects_intersect_ident(sub(cand[2 * j], cand[2 * i]), sub(cand[2 * j + 1], cand[2 * i + 1]),
                                       mc.c_sample_pair_x[i], mc.c_sample_pair_y[i], mc.c_sample_pair_x[j],
                                       mc.c_sample_pair_y[j], mc.sample_pair_sum_x[p], mc.sample_pair_sum_y[p]);
        } else {
          ok &= !(sqrtf(sq2(dx, dy)) <= mc.sample_pair_sum_x[p]);
        }
      }
    }
    if (ok) {
#pragma unroll
      for (int k2 = 0; k2 < 2 * M; ++k2) best[k2] = cand[k2];
      found = true;
    }
  }
}

// One M-mover autoreset env step.  Output planes (18M + 6, the Pallas
// raw_planes order): state P, V, A, G (2M each), steps; post-reset obs
// (vel, achieved: 2M each); pre-reset obs (vel, achieved, act: 2M each);
// wall, mover, num_unreached, stalled, trials.  Consumes
// (2 + 4p) * M * num_cycles + 8M + 4M * cand_k draws.
template <int M, bool kBox, bool kFull, class Noise>
__device__ __forceinline__ void multi_autoreset_step(const PlanningLaunch& L, const MultiConsts& mc, Noise& noise,
                                                     MultiState<M>& s, const float (&U)[2 * M],
                                                     float* __restrict__ out, int64_t B, int64_t e) {
  const PlanningConsts& c = L.c;
  float wall_f, mover_f;
  multi_cycles<M, kBox, kFull>(L, mc, noise, s, U, wall_f, mover_f);

  // pre-reset observation and the goals reached within the noisy threshold
  float* o = out + (8 * M + 1) * B + e;
  float f_ag[2 * M], f_v[2 * M];
  float num_unreached = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float n1, n2, n3, n4;
    normal_pair(noise, n1, n2);
    normal_pair(noise, n3, n4);
    f_ag[2 * i] = madd(s.P[2 * i], n1, c.std_pos);
    f_ag[2 * i + 1] = madd(s.P[2 * i + 1], n2, c.std_pos);
    f_v[2 * i] = madd(s.V[2 * i], n3, c.std_vel);
    f_v[2 * i + 1] = madd(s.V[2 * i + 1], n4, c.std_vel);
    const float ddx = sub(f_ag[2 * i], s.G[2 * i]), ddy = sub(f_ag[2 * i + 1], s.G[2 * i + 1]);
    num_unreached = add(num_unreached, sqrtf(sq2(ddx, ddy)) <= c.threshold ? 0.0f : 1.0f);
  }
#pragma unroll
  for (int k = 0; k < 2 * M; ++k) {
    o[(4 * M + k) * B] = f_v[k];
    o[(6 * M + k) * B] = f_ag[k];
    o[(8 * M + k) * B] = s.A[k];  // pre-reset act (jerk-mode final observation)
  }
  const bool collided = (wall_f > 0.0f) | (mover_f > 0.0f);
  const bool term = collided | (num_unreached == 0.0f);
  const float new_steps = add(s.steps, 1.0f);
  const bool trunc = new_steps >= c.max_episode_steps;
  const bool done = term | trunc;

  float starts[2 * M], goals[2 * M];
  float s_trials = 0.0f, g_trials = 0.0f;
  bool s_found = false, g_found = false;
  if (done) {
    sample_set<M, kBox, kFull, false>(L, mc, noise, starts, s_found, s_trials);
    sample_set<M, kBox, kFull, true>(L, mc, noise, goals, g_found, g_trials);
  } else {
    noise.skip(4 * M * L.cand_k);
  }
  // a stalled sampler (no accepted set) does not restart the env: state and
  // step counter carry over, done fires again next step
  const bool found = s_found & g_found;
  const bool do_reset = done & found;
  if (do_reset) {
#pragma unroll
    for (int k = 0; k < 2 * M; ++k) {
      s.P[k] = starts[k];
      s.V[k] = 0.0f;
      s.A[k] = 0.0f;
      s.G[k] = goals[k];
    }
    s.steps = 0.0f;
  } else {
    s.steps = new_steps;
  }

  // post-reset observation (the pre-reset one where the env carries on)
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float m1, m2, m3, m4;
    normal_pair(noise, m1, m2);
    normal_pair(noise, m3, m4);
    o[(2 * i) * B] = do_reset ? madd(s.V[2 * i], m3, c.std_vel) : f_v[2 * i];
    o[(2 * i + 1) * B] = do_reset ? madd(s.V[2 * i + 1], m4, c.std_vel) : f_v[2 * i + 1];
    o[(2 * M + 2 * i) * B] = do_reset ? madd(s.P[2 * i], m1, c.std_pos) : f_ag[2 * i];
    o[(2 * M + 2 * i + 1) * B] = do_reset ? madd(s.P[2 * i + 1], m2, c.std_pos) : f_ag[2 * i + 1];
  }
  o[(10 * M + 0) * B] = wall_f;
  o[(10 * M + 1) * B] = mover_f;
  o[(10 * M + 2) * B] = num_unreached;
  o[(10 * M + 3) * B] = (done & !found) ? 1.0f : 0.0f;
  o[(10 * M + 4) * B] = done ? add(s_trials, g_trials) : 0.0f;
}

template <int M, bool kBox, bool kFull, bool kInject>
__global__ void __launch_bounds__(kThreads)
    planning_multi_autoreset_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                                    const float* __restrict__ noise, float* __restrict__ out, int64_t B,
                                    const PlanningLaunch L, const MultiConsts mc, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  MultiState<M> s;
  float U[2 * M];
#pragma unroll
  for (int k = 0; k < 2 * M; ++k) {
    s.P[k] = st_in[(0 * M + k) * B + e];
    s.V[k] = st_in[(2 * M + k) * B + e];
    s.A[k] = st_in[(4 * M + k) * B + e];
    s.G[k] = st_in[(6 * M + k) * B + e];
    U[k] = act[k * B + e];
  }
  s.steps = st_in[(8 * M) * B + e];
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    multi_autoreset_step<M, kBox, kFull>(L, mc, n, s, U, out, B, e);
  } else {
    PhiloxNoise n(seed, e);
    multi_autoreset_step<M, kBox, kFull>(L, mc, n, s, U, out, B, e);
  }
#pragma unroll
  for (int k = 0; k < 2 * M; ++k) {
    out[(0 * M + k) * B + e] = s.P[k];
    out[(2 * M + k) * B + e] = s.V[k];
    out[(4 * M + k) * B + e] = s.A[k];
    out[(6 * M + k) * B + e] = s.G[k];
  }
  out[(8 * M) * B + e] = s.steps;
}

template <int M, bool kBox, bool kFull, bool kInject>
void launch_multi_kernel(const float* st, const float* act, const float* noise, float* out, int64_t B,
                         const PlanningLaunch& L, const MultiConsts& mc, Seed seed, cudaStream_t s) {
  planning_multi_autoreset_kernel<M, kBox, kFull, kInject>
      <<<num_blocks(B), kThreads, 0, s>>>(st, act, noise, out, B, L, mc, seed);
}

// Host side: launch kernel H for M movers and one collision shape, by the
// layout rule and the noise mode.  Defined here, instantiated once per
// (M, shape) in planning_multi_m<M>_<shape>.cu: one nvcc process each, so
// the 56 instantiations compile in parallel.
template <int M, bool kBox>
void launch_planning_multi(bool full, bool inject, const float* st, const float* act, const float* noise, float* out,
                           int64_t B, const PlanningLaunch& L, const MultiConsts& mc, Seed seed, cudaStream_t s) {
  if (full) {
    (inject ? launch_multi_kernel<M, kBox, true, true> : launch_multi_kernel<M, kBox, true, false>)(
        st, act, noise, out, B, L, mc, seed, s);
  } else {
    (inject ? launch_multi_kernel<M, kBox, false, true> : launch_multi_kernel<M, kBox, false, false>)(
        st, act, noise, out, B, L, mc, seed, s);
  }
}

#define GPRT_MULTI_LAUNCH_SIGNATURE(M, BOX)                                                                    \
  void launch_planning_multi<M, BOX>(bool, bool, const float*, const float*, const float*, float*, int64_t, \
                                     const PlanningLaunch&, const MultiConsts&, Seed, cudaStream_t)

}  // namespace gprt
