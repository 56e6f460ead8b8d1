// Kernel H: one M-mover planning autoreset env step, for any M from 2 to
// kMaxMovers (735) (device functions and the launchers; the C interface is in
// planning_multi_autoreset.cu).  The slot variants (below) keep the movers in
// register slots, up to kMaxSlotMovers (128); the many-mover variant (at the
// end of this file) keeps them in shared memory and runs any M.  The wrapper
// picks by M and width (LANE_TABLE in ops/kernels/planning_multi.py): the
// slots up to 87 movers, the many-mover variant from 88.
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
// (0.45 KB per env), so bytes do not bind.  What binds is the length of one
// env's dependent chain: one thread per env ran M movers' physics and all
// pairs one after another, and at 4096 envs filled a quarter of the card.
//
// Design: lane groups.  An env is a group of G lanes of one warp (G a power
// of two up to 32, chosen at run time); each lane owns L mover slots in
// registers (mover i on lane i % G, slot i / G; L a template parameter, G * L
// >= M).  A control cycle is three group steps.  (1) The cycle's draws read
// no state, so the whole group draws them: the cycle's (2 + 4p) M uniforms
// are cut into Philox blocks (4 uniforms, two normal pairs: draw d of env e
// is word d % 4 of the block at counter (d / 4, e), or injected plane d),
// dealt round-robin over the G lanes, and their normals go to the group's
// buffer in shared memory: each Philox block is computed once, and a lane
// that owns no mover (G > M) still draws.  (2) Each lane runs its own
// movers' clamp chain, integration and wall check from the buffer, and
// writes their pair-test poses to shared memory.  (3) The M(M-1)/2 pairs are
// dealt round-robin over the lanes from a pair list the block builds once;
// the wall and mover flags are one OR over the group (__reduce_or_sync with
// the group's mask).  The reached count is an integer sum, a candidate set's
// acceptance an AND, so the latch, termination and the restart are uniform
// over the group.  Once latched the state cannot change, so the group leaves
// the cycle loop: the skipped draws are never read.  The per-mover sizes,
// accel_scale and the per-pair sums (formed in float64 on the host, rounded
// once) come from a device tensor the wrapper made once, copied into shared
// memory by each block.  As before, an env that is not done passes over the
// sampling draws unread, and a sampler stops at its first accepted set.  The
// layout rule and the noise mode are run-time branches, uniform over the
// launch: six instantiations (L in {1, 2, 4} x collision shape) keep the
// build short; L = 4 is taken only at 65-87 movers, where 32 lanes of 2 slots
// no longer hold them.
//
// Every product and sum is rounded on its own (common.cuh), as the plain
// PyTorch version's eager ops do (ops/kernels/planning_multi.py), so the two
// agree bit for bit.

#pragma once

#include "planning.cuh"

namespace gprt {

// The most movers the slot variants take: 32 lanes of 4 slots hold 128, and
// at 128 a block's shared memory (the constants, 8,128 pairs, and its four
// groups' poses and cycle normals) is 159,392 bytes for the box (132 KB
// circle), one block an SM under the 227 KB a block may take.  The pair
// list's i | j << 8 holds indices up to 255.  Above 128 only the many-mover
// variant runs, up to kMaxMovers (below).
constexpr int kMaxSlotMovers = 128;

// The per-mover and per-pair constants, one f32 vector in device memory.
// Field order and each field's length rule (m: one per mover, pairs: one per
// pair (i, j), i < j, in row order, 1: a scalar) are the contract with
// MULTI_FIELDS in ops/kernels/planning_multi.py, checked at load time
// through gprt_multi_const_names().  Sizes are radii (circle: *_x, *_y equal)
// or half-extents (box): c_wall = c + offset_wall (cycle wall check),
// c_sample = c + offset + offset_wall (reset wall check), c_sample_pair = c +
// offset (reset pair test), c_pair = c (cycle pair test).  pair_sum (circle)
// and sample_pair_sum_x/_y are the summed sizes of pair p, formed in float64
// and rounded once.
#define GPRT_MULTI_FIELDS(X)                                                                                   \
  X(c_wall_x, m) X(c_wall_y, m) X(c_sample_x, m) X(c_sample_y, m) X(c_sample_pair_x, m) X(c_sample_pair_y, m) \
  X(c_pair_x, m) X(c_pair_y, m) X(accel_scale, m) X(pair_sum, pairs) X(sample_pair_sum_x, pairs)             \
  X(sample_pair_sum_y, pairs) X(min_goal_dist, 1)

#define GPRT_MULTI_LEN_m(m, pairs) (m)
#define GPRT_MULTI_LEN_pairs(m, pairs) (pairs)
#define GPRT_MULTI_LEN_1(m, pairs) 1

__host__ __device__ inline int num_pairs(int m) { return m * (m - 1) / 2; }

// floats of the constants vector for m movers
__host__ __device__ inline int multi_const_floats(int m) {
  const int pairs = num_pairs(m);
  int n = 0;
#define GPRT_ADD_LEN(name, rule) n += GPRT_MULTI_LEN_##rule(m, pairs);
  GPRT_MULTI_FIELDS(GPRT_ADD_LEN)
#undef GPRT_ADD_LEN
  return n;
}

// The fields of the constants vector at ``base`` for m movers.
struct MultiConsts {
#define GPRT_DECLARE_PTR(name, rule) const float* name;
  GPRT_MULTI_FIELDS(GPRT_DECLARE_PTR)
#undef GPRT_DECLARE_PTR
  __device__ MultiConsts(const float* base, int m) {
    const int pairs = num_pairs(m);
    int off = 0;
#define GPRT_SET_PTR(name, rule) \
  name = base + off;             \
  off += GPRT_MULTI_LEN_##rule(m, pairs);
    GPRT_MULTI_FIELDS(GPRT_SET_PTR)
#undef GPRT_SET_PTR
  }
};

// The holed layouts' per-cell rule as one call: one copy per instantiation
// instead of one inlined per wall check and sampled mover.  Full layouts keep
// the inlined closed form.
template <bool kBox>
__device__ __noinline__ bool holed_valid(const WallTable& t, float px, float py, Rot2 R, float sx, float sy) {
  return kBox ? box_valid_general(t, px, py, R, sx, sy) : circle_valid_general(t, px, py, sx);
}

template <bool kBox>
__device__ __forceinline__ bool multi_shape_valid(const PlanningLaunch& L, bool full, float px, float py, const Rot2& R,
                                                  float sx, float sy) {
  if (full) return shape_valid<kBox, true>(L, px, py, R, sx, sy);
  return holed_valid<kBox>(L.table, px, py, R, sx, sy);
}

// the rotation of quaternion noise (q1 .. q4) around the identity
__device__ __forceinline__ Rot2 rotation_of(float q1, float q2, float q3, float q4, float std_pos) {
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

// ---------------------------------------------------------------------------
// draws by absolute index, injected or Philox (a run-time mode)
// ---------------------------------------------------------------------------

// A stream positioned at a draw of one env, in either mode.
struct DrawStream {
  const float* p;  // injected: the next draw's address, else null
  int64_t stride;
  PhiloxNoise ph;
  __device__ __forceinline__ float uniform() {
    if (p != nullptr) {
      const float u = *p;
      p += stride;
      return u;
    }
    return ph.uniform();
  }
};

struct Draws {
  const float* noise;  // injected uniforms [N, B], or null: Philox under seed
  int64_t B;
  uint64_t seed;
  __device__ __forceinline__ DrawStream at(int64_t e, uint32_t d) const {
    DrawStream s{noise == nullptr ? nullptr : noise + e + static_cast<int64_t>(d) * B, B, PhiloxNoise(seed, e)};
    if (noise == nullptr) s.ph.skip(static_cast<int>(d));
    return s;
  }
  // the uniforms of block b (draws 4b ... 4b + 3); injected, only the draws
  // in [lo, hi) are read (the others are 0)
  __device__ __forceinline__ void block(int64_t e, uint32_t b, uint32_t lo, uint32_t hi, float (&u)[4]) const {
    if (noise != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t d = 4 * b + k;
        u[k] = (d >= lo && d < hi) ? noise[static_cast<int64_t>(d) * B + e] : 0.0f;
      }
    } else {
      const uint4 c = philox4x32_10(make_uint4(b, static_cast<uint32_t>(e), 0u, 0u),
                                    make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)));
      u[0] = bits_to_uniform(c.x);
      u[1] = bits_to_uniform(c.y);
      u[2] = bits_to_uniform(c.z);
      u[3] = bits_to_uniform(c.w);
    }
  }
};

// ---------------------------------------------------------------------------
// lane groups
// ---------------------------------------------------------------------------

// One env's G lanes: this lane's index in the group and the group's lanes
// within the warp.  Every vote names the group's lanes only, so groups of one
// warp that take different branches (done or not) never wait on each other.
struct Group {
  int lane, G;
  unsigned mask;
  __device__ Group(int lane_, int G_)
      : lane(lane_), G(G_),
        mask(G_ == 32 ? 0xffffffffu : ((1u << G_) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(G_ - 1))) {}
  __device__ __forceinline__ void sync() const {
    if (G > 1) __syncwarp(mask);
  }
  __device__ __forceinline__ unsigned any(unsigned bits) const {
    return G > 1 ? __reduce_or_sync(mask, bits) : bits;
  }
  __device__ __forceinline__ bool all(bool v) const {
    return G > 1 ? __reduce_and_sync(mask, v ? 1u : 0u) != 0u : v;
  }
  __device__ __forceinline__ unsigned sum(unsigned v) const { return G > 1 ? __reduce_add_sync(mask, v) : v; }
};

// The block's shared memory: the constants, the pair list (i | j << 8), and
// each group's poses (x, y, for the box also R's four entries, each as M
// floats) and its cycle's normals ((2 + 4p) M, in draw order); one float of
// padding per group spreads the groups over the banks.
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int cycle_draws(int m, bool box) { return (2 + 4 * (box ? 3 : 1)) * m; }
__host__ __device__ inline int group_floats(int m, bool box) { return (box ? 6 : 2) * m + cycle_draws(m, box) + 1; }
__host__ __device__ inline int pair_list_floats(int m) { return round4((num_pairs(m) + 1) / 2); }
inline size_t multi_smem_bytes(int m, int G, bool box) {
  return sizeof(float) * static_cast<size_t>(round4(multi_const_floats(m)) + pair_list_floats(m) +
                                             (kThreads / G) * group_floats(m, box));
}

// A lane's mover slots: slot l is mover lane + l * G while that is < M.
template <int L>
struct Slots {
  float px[L], py[L], vx[L], vy[L], ax[L], ay[L], gx[L], gy[L], ux[L], uy[L];
};

// What a group's lanes share during a launch.
struct GroupEnv {
  const PlanningLaunch& L;
  const MultiConsts& mc;
  const uint16_t* pairs;  // [num_pairs(M)] (i | j << 8) in row order
  float* pose;            // this group's poses
  float* normals;         // this group's cycle normals
  int64_t e;
  int M;
  bool full;  // the layout rule: closed form (fully populated) or the table
  Group g;
};

// Step (1) of a cycle: the normals of the cycle's draws [d0, d0 + n) into
// the group's buffer, Philox blocks dealt round-robin over the lanes.
__device__ __forceinline__ void group_normals(const GroupEnv& ge, const Draws& dr, uint32_t d0, int n) {
  const uint32_t hi = d0 + static_cast<uint32_t>(n);
  for (uint32_t b = d0 / 4 + static_cast<uint32_t>(ge.g.lane); b <= (hi - 1) / 4; b += static_cast<uint32_t>(ge.g.G)) {
    float u[4];
    dr.block(ge.e, b, d0, hi, u);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t d = 4 * b + 2 * k;
      if (d >= d0 && d < hi) {
        float a, c;
        box_muller(u[2 * k], u[2 * k + 1], a, c);
        ge.normals[d - d0] = a;
        ge.normals[d - d0 + 1] = c;
      }
    }
  }
}

// num_cycles control cycles of all M movers with the shared-fate latch; the
// cycle's draws are (2 + 4p) M (p = 3 box, 1 circle), per mover i: the
// velocity pair at 2i, the wall pose at 2M + 2p i, the pair-test pose at 2M +
// 2p M + 2p i.  Returns the wall and mover flags (0 or 1).
template <int L, bool kBox>
__device__ __forceinline__ void group_cycles(const GroupEnv& ge, const Draws& dr, Slots<L>& s, float& wall_f,
                                             float& mover_f) {
  const PlanningConsts& c = ge.L.c;
  const MultiConsts& mc = ge.mc;
  const int M = ge.M, p_w = kBox ? 3 : 1, n_pairs = num_pairs(M), n_draws = cycle_draws(M, kBox);
  const Rot2 ident = {1.0f, 0.0f, 0.0f, 1.0f};
  float* pose = ge.pose;
  const float* nb = ge.normals;
  wall_f = 0.0f;
  mover_f = 0.0f;
  for (int cyc = 0; cyc < ge.L.num_cycles; ++cyc) {
    group_normals(ge, dr, static_cast<uint32_t>(cyc * n_draws), n_draws);
    ge.g.sync();
    bool wall = false;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int i = ge.g.lane + l * ge.g.G;
      if (i < M) {
        const float vmx = madd(s.vx[l], nb[2 * i], c.std_vel), vmy = madd(s.vy[l], nb[2 * i + 1], c.std_vel);
        const float scale = mc.accel_scale[i];
        const float amx = mul(scale, s.ax[l]), amy = mul(scale, s.ay[l]);
        float nax, nay;
        if (ge.L.jerk) {
          clamp_chain<true>(c.v_max, c.a_max, c.dt, vmx, vmy, s.ux[l], s.uy[l], amx, amy, s.ax[l], s.ay[l], nax, nay);
        } else {
          clamp_chain<false>(c.v_max, c.a_max, c.dt, vmx, vmy, s.ux[l], s.uy[l], amx, amy, s.ax[l], s.ay[l], nax,
                             nay);
        }
        s.vx[l] = madd(s.vx[l], c.dt, mul(scale, nax));
        s.vy[l] = madd(s.vy[l], c.dt, mul(scale, nay));
        s.px[l] = madd(s.px[l], c.dt, s.vx[l]);
        s.py[l] = madd(s.py[l], c.dt, s.vy[l]);
        s.ax[l] = nax;
        s.ay[l] = nay;
        // the mover's wall check on its own pose noise and size
        const float* w = nb + 2 * M + 2 * p_w * i;
        const Rot2 R = kBox ? rotation_of(w[2], w[3], w[4], w[5], c.std_pos) : ident;
        wall |= !multi_shape_valid<kBox>(ge.L, ge.full, madd(s.px[l], w[0], c.std_pos),
                                         madd(s.py[l], w[1], c.std_pos), R, mc.c_wall_x[i], mc.c_wall_y[i]);
        // a second, independent noisy pose for the pair tests
        const float* q = nb + 2 * M + 2 * p_w * M + 2 * p_w * i;
        pose[i] = madd(s.px[l], q[0], c.std_pos);
        pose[M + i] = madd(s.py[l], q[1], c.std_pos);
        if (kBox) {
          const Rot2 Rq = rotation_of(q[2], q[3], q[4], q[5], c.std_pos);
          pose[2 * M + i] = Rq.r00;
          pose[3 * M + i] = Rq.r01;
          pose[4 * M + i] = Rq.r10;
          pose[5 * M + i] = Rq.r11;
        }
      }
    }
    ge.g.sync();
    bool hit = false;
    for (int p = ge.g.lane; p < n_pairs; p += ge.g.G) {
      const int i = ge.pairs[p] & 0xff, j = ge.pairs[p] >> 8;
      if (kBox) {
        const Rot2 Ri = {pose[2 * M + i], pose[3 * M + i], pose[4 * M + i], pose[5 * M + i]};
        const Rot2 Rj = {pose[2 * M + j], pose[3 * M + j], pose[4 * M + j], pose[5 * M + j]};
        hit |= rects_intersect_sat(sub(pose[j], pose[i]), sub(pose[M + j], pose[M + i]), Ri, mc.c_pair_x[i],
                                   mc.c_pair_y[i], Rj, mc.c_pair_x[j], mc.c_pair_y[j]);
      } else {
        hit |= sqrtf(sq2(sub(pose[i], pose[j]), sub(pose[M + i], pose[M + j]))) <= mc.pair_sum[p];
      }
    }
    const unsigned flags = ge.g.any((wall ? 1u : 0u) | (hit ? 2u : 0u));
    ge.g.sync();  // this cycle's reads before the next cycle's writes
    if (flags != 0u) {
      // latched: the state is frozen for the remaining cycles
      wall_f = (flags & 1u) ? 1.0f : 0.0f;
      mover_f = (flags & 2u) ? 1.0f : 0.0f;
      break;
    }
  }
}

// First accepted of cand_k candidate sets of M positions (sample_set in the
// Pallas kernel), set k's draws at d_set + 2 M k (mover i: x at + 2i, y at +
// 2i + 1): every mover wall-valid at the identity orientation with its
// sampling size, and every pair apart (start sets: no collision at the summed
// sizes with the safety offset; goal sets: distance >= min_goal_dist).  Sets
// after the first accepted one are never drawn.  Returns found; trials counts
// the sets tested.
template <int L, bool kBox, bool kGoal>
__device__ __forceinline__ bool group_sample(const GroupEnv& ge, const Draws& dr, uint32_t d_set, float (&bx)[L],
                                             float (&by)[L], float& trials) {
  const PlanningConsts& c = ge.L.c;
  const MultiConsts& mc = ge.mc;
  const int M = ge.M, n_pairs = num_pairs(M);
  const Rot2 ident = {1.0f, 0.0f, 0.0f, 1.0f};
  float* pose = ge.pose;
  for (int k = 0; k < ge.L.cand_k; ++k) {
    bool ok = true;
    float cx[L], cy[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int i = ge.g.lane + l * ge.g.G;
      if (i < M) {
        auto n = dr.at(ge.e, d_set + static_cast<uint32_t>(2 * M * k + 2 * i));
        cx[l] = uniform_in(n, c.min_x, c.span_x);
        cy[l] = uniform_in(n, c.min_y, c.span_y);
        ok &= multi_shape_valid<kBox>(ge.L, ge.full, cx[l], cy[l], ident, mc.c_sample_x[i], mc.c_sample_y[i]);
        pose[i] = cx[l];
        pose[M + i] = cy[l];
      }
    }
    ge.g.sync();
    for (int p = ge.g.lane; p < n_pairs; p += ge.g.G) {
      const int i = ge.pairs[p] & 0xff, j = ge.pairs[p] >> 8;
      const float dx = sub(pose[i], pose[j]), dy = sub(pose[M + i], pose[M + j]);
      if (kGoal) {
        ok &= sqrtf(sq2(dx, dy)) >= mc.min_goal_dist[0];
      } else if (kBox) {
        ok &= !rects_intersect_ident(sub(pose[j], pose[i]), sub(pose[M + j], pose[M + i]), mc.c_sample_pair_x[i],
                                     mc.c_sample_pair_y[i], mc.c_sample_pair_x[j], mc.c_sample_pair_y[j],
                                     mc.sample_pair_sum_x[p], mc.sample_pair_sum_y[p]);
      } else {
        ok &= !(sqrtf(sq2(dx, dy)) <= mc.sample_pair_sum_x[p]);
      }
    }
    const bool accepted = ge.g.all(ok);
    ge.g.sync();  // this set's reads before the next writes
    if (accepted) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        bx[l] = cx[l];
        by[l] = cy[l];
      }
      trials = static_cast<float>(k + 1);
      return true;
    }
  }
  trials = static_cast<float>(ge.L.cand_k);
  return false;
}

// One M-mover autoreset env step of one group.  Output planes (18M + 6, the
// Pallas raw_planes order): state P, V, A, G (2M each), steps; post-reset obs
// (vel, achieved: 2M each); pre-reset obs (vel, achieved, act: 2M each);
// wall, mover, num_unreached, stalled, trials.  Draws (2 + 4p) M num_cycles
// for the cycles, then per mover 4 for the pre-reset observation (at 4i), 2
// M cand_k for the start sets and as many for the goal sets, 4 for the
// post-reset observation (at 4i).
template <int L, bool kBox>
__device__ __forceinline__ void group_step(const GroupEnv& ge, const Draws& dr, const float* __restrict__ st_in,
                                           const float* __restrict__ act, float* __restrict__ out, int64_t B) {
  const PlanningConsts& c = ge.L.c;
  const int M = ge.M;
  const int64_t e = ge.e;
  Slots<L> s;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = ge.g.lane + l * ge.g.G;
    if (i < M) {
      s.px[l] = st_in[(2 * i) * B + e];
      s.py[l] = st_in[(2 * i + 1) * B + e];
      s.vx[l] = st_in[(2 * M + 2 * i) * B + e];
      s.vy[l] = st_in[(2 * M + 2 * i + 1) * B + e];
      s.ax[l] = st_in[(4 * M + 2 * i) * B + e];
      s.ay[l] = st_in[(4 * M + 2 * i + 1) * B + e];
      s.gx[l] = st_in[(6 * M + 2 * i) * B + e];
      s.gy[l] = st_in[(6 * M + 2 * i + 1) * B + e];
      s.ux[l] = act[(2 * i) * B + e];
      s.uy[l] = act[(2 * i + 1) * B + e];
    }
  }
  const float steps = st_in[(8 * M) * B + e];
  float wall_f, mover_f;
  group_cycles<L, kBox>(ge, dr, s, wall_f, mover_f);

  // pre-reset observation and the goals reached within the noisy threshold
  const uint32_t d_obs = static_cast<uint32_t>(ge.L.num_cycles * cycle_draws(M, kBox));
  float* o = out + (8 * M + 1) * B + e;
  float fvx[L], fvy[L], fagx[L], fagy[L];
  unsigned unreached = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = ge.g.lane + l * ge.g.G;
    if (i < M) {
      auto n = dr.at(e, d_obs + 4 * i);
      float n1, n2, n3, n4;
      normal_pair(n, n1, n2);
      normal_pair(n, n3, n4);
      fagx[l] = madd(s.px[l], n1, c.std_pos);
      fagy[l] = madd(s.py[l], n2, c.std_pos);
      fvx[l] = madd(s.vx[l], n3, c.std_vel);
      fvy[l] = madd(s.vy[l], n4, c.std_vel);
      const float ddx = sub(fagx[l], s.gx[l]), ddy = sub(fagy[l], s.gy[l]);
      unreached += sqrtf(sq2(ddx, ddy)) <= c.threshold ? 0u : 1u;
      o[(4 * M + 2 * i) * B] = fvx[l];
      o[(4 * M + 2 * i + 1) * B] = fvy[l];
      o[(6 * M + 2 * i) * B] = fagx[l];
      o[(6 * M + 2 * i + 1) * B] = fagy[l];
      o[(8 * M + 2 * i) * B] = s.ax[l];  // pre-reset act (jerk-mode final observation)
      o[(8 * M + 2 * i + 1) * B] = s.ay[l];
    }
  }
  const float num_unreached = static_cast<float>(ge.g.sum(unreached));
  const bool collided = (wall_f > 0.0f) | (mover_f > 0.0f);
  const bool term = collided | (num_unreached == 0.0f);
  const float new_steps = add(steps, 1.0f);
  const bool trunc = new_steps >= c.max_episode_steps;
  const bool done = term | trunc;

  // restart: start sets, then goal sets; an env that is not done reads none
  const uint32_t d_starts = d_obs + 4 * M;
  const uint32_t d_goals = d_starts + static_cast<uint32_t>(2 * M * ge.L.cand_k);
  float sx[L], sy[L], gx[L], gy[L];
  float s_trials = 0.0f, g_trials = 0.0f;
  bool found = false;
  if (done) {
    const bool s_found = group_sample<L, kBox, false>(ge, dr, d_starts, sx, sy, s_trials);
    const bool g_found = group_sample<L, kBox, true>(ge, dr, d_goals, gx, gy, g_trials);
    found = s_found & g_found;
  }
  // a stalled sampler (no accepted set) does not restart the env: state and
  // step counter carry over, done fires again next step
  const bool do_reset = done & found;
  const uint32_t d_post = d_goals + static_cast<uint32_t>(2 * M * ge.L.cand_k);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = ge.g.lane + l * ge.g.G;
    if (i < M) {
      float svx = fvx[l], svy = fvy[l], sagx = fagx[l], sagy = fagy[l];
      if (do_reset) {
        s.px[l] = sx[l];
        s.py[l] = sy[l];
        s.vx[l] = s.vy[l] = s.ax[l] = s.ay[l] = 0.0f;
        s.gx[l] = gx[l];
        s.gy[l] = gy[l];
        // post-reset observation (the pre-reset one where the env carries on)
        auto n = dr.at(e, d_post + 4 * i);
        float m1, m2, m3, m4;
        normal_pair(n, m1, m2);
        normal_pair(n, m3, m4);
        sagx = madd(s.px[l], m1, c.std_pos);
        sagy = madd(s.py[l], m2, c.std_pos);
        svx = madd(s.vx[l], m3, c.std_vel);
        svy = madd(s.vy[l], m4, c.std_vel);
      }
      o[(2 * i) * B] = svx;
      o[(2 * i + 1) * B] = svy;
      o[(2 * M + 2 * i) * B] = sagx;
      o[(2 * M + 2 * i + 1) * B] = sagy;
      out[(2 * i) * B + e] = s.px[l];
      out[(2 * i + 1) * B + e] = s.py[l];
      out[(2 * M + 2 * i) * B + e] = s.vx[l];
      out[(2 * M + 2 * i + 1) * B + e] = s.vy[l];
      out[(4 * M + 2 * i) * B + e] = s.ax[l];
      out[(4 * M + 2 * i + 1) * B + e] = s.ay[l];
      out[(6 * M + 2 * i) * B + e] = s.gx[l];
      out[(6 * M + 2 * i + 1) * B + e] = s.gy[l];
    }
  }
  if (ge.g.lane == 0) {
    out[(8 * M) * B + e] = do_reset ? 0.0f : new_steps;
    o[(10 * M + 0) * B] = wall_f;
    o[(10 * M + 1) * B] = mover_f;
    o[(10 * M + 2) * B] = num_unreached;
    o[(10 * M + 3) * B] = (done & !found) ? 1.0f : 0.0f;
    o[(10 * M + 4) * B] = done ? add(s_trials, g_trials) : 0.0f;
  }
}

// One block of kThreads lanes: kThreads / G envs.  The block copies the
// constants into shared memory and builds the pair list, then each group
// runs its env's step.
template <int L, bool kBox>
__global__ void __launch_bounds__(kThreads)
    planning_multi_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                          const float* __restrict__ noise, float* __restrict__ out, int64_t B, const PlanningLaunch Lc,
                          const float* __restrict__ consts, int M, int G, bool full, Seed seed) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n_const = multi_const_floats(M);
  for (int k = threadIdx.x; k < n_const; k += blockDim.x) sm[k] = consts[k];
  uint16_t* pairs = reinterpret_cast<uint16_t*>(sm + round4(n_const));
  for (int i = threadIdx.x; i < M - 1; i += blockDim.x) {
    int p = i * (2 * M - i - 1) / 2;
    for (int j = i + 1; j < M; ++j) pairs[p++] = static_cast<uint16_t>(i | (j << 8));
  }
  const int gib = threadIdx.x / G;  // the group's index in the block
  float* group = sm + round4(n_const) + pair_list_floats(M) + gib * group_floats(M, kBox);
  __syncthreads();
  const int64_t e = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + gib;
  if (e >= B) return;  // a whole group: its lanes share e
  const MultiConsts mc(sm, M);
  const GroupEnv ge{Lc, mc, pairs, group, group + (kBox ? 6 : 2) * M, e, M, full, Group(threadIdx.x % G, G)};
  group_step<L, kBox>(ge, Draws{noise, B, noise == nullptr ? seed.get() : 0}, st_in, act, out, B);
}

// Host side: launch kernel H with L slots a lane and one collision shape.
template <int L, bool kBox>
cudaError_t launch_planning_multi(const float* st, const float* act, const float* noise, float* out, int64_t B,
                                  const PlanningLaunch& Lc, const float* consts, int M, int G, bool full, Seed seed,
                                  cudaStream_t s) {
  const size_t smem = multi_smem_bytes(M, G, kBox);
  auto kernel = planning_multi_kernel<L, kBox>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t groups = kThreads / G;
  kernel<<<static_cast<unsigned int>((B + groups - 1) / groups), kThreads, smem, s>>>(st, act, noise, out, B, Lc,
                                                                                     consts, M, G, full, seed);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The many-mover variant: any M up to kMaxMovers, the movers in shared memory
// ---------------------------------------------------------------------------
//
// Above 128 movers the slot variants run out of room twice: 32 lanes of 4
// register slots hold 128 movers (L = 4 already takes 168 registers, and the
// box spills), and the per-pair arrays grow with M^2 (3 x 8,128 floats of a
// block's 159,392 bytes at 128 box movers).  This variant keeps neither, and
// from 88 movers it is also the faster (measured at 33-128 movers):
//
// - An env is one warp.  Lane l walks movers l, l + 32, ...; each mover's
//   cycle state (position, velocity, acceleration, action: 8 floats) lives in
//   the group's shared memory and only its own lane touches it.  The
//   per-mover constants are read from device memory (L1), O(M) a cycle.
// - A lane draws its own movers' cycle normals (DrawStream at the mover's
//   absolute draw index), so the group keeps no buffer of the cycle's
//   normals; a Philox block shared by two movers is computed twice, O(M) a
//   cycle beside the O(M^2) pair tests.
// - What a pair test reads of a mover is one record: float4 a (x, y, then
//   the test's sizes: the circle's float64 size as its two words, the box's
//   f32 half-extents) and, for the box, float4 b (the cycle's rotation, or
//   the start sets' two float64 sizes), written by the mover's lane; a
//   pair's summed sizes are added in float64 and rounded once, the f32 the
//   host rounds into its per-pair table (make_multi_kernel_consts).
// - The pairs are walked in a folded order (walk_pairs): lanes own whole
//   rows with the lower mover in registers, read their partners at
//   consecutive records, and take counts that differ by at most one; every
//   pair is still tested as (lower, higher).  A candidate set's walk ends at
//   the first warp vote that sees a rejecting pair (and a set that a wall
//   check rejects skips its walk): random sets of 33 or more movers are
//   rejected within a few votes instead of walking all pairs of all 2 cand_k
//   sets of every done env.  A cycle's walk votes once, at its end: it
//   rarely hits, and a vote a pair cost more than it saved.
// - A block holds 4 envs, or 2 or 1 where that lets an SM hold clearly more
//   envs by shared memory and registers (many_envs_per_block).
//
// Draws, the cycle order, the latch, the restart and every rounding are the
// slot variants', so this variant agrees with the plain version bit for bit:
// skipping a set's pairs shifts no draw (draws are indexed by set and mover),
// trials counts sets, and the first set whose pairs all pass is the first
// accepted one.  Bound: as the slot variants; what limits a launch here is
// the instructions a pair takes (a shared load and the test; in a set's walk
// a vote) and the envs an SM holds.

// The slot variants' constants vector begins with its nine per-mover fields
// (GPRT_MULTI_FIELDS) and ends with min_goal_dist; this variant reads those.
enum ManyField { kWallX, kWallY, kSampleX, kSampleY, kSamplePairX, kSamplePairY, kPairX, kPairY, kAccelScale };
constexpr int kManyFields = 9;
// [3, M] float64 per-mover sizes, rows: c_pair_x (the circle's cycle pair
// test), c_sample_pair_x, c_sample_pair_y (the start sets' pair test)
constexpr int kMany64Rows = 3;

// a group's float4s: the records a [M] (and b [M], box), then the state
// [8, M] floats (x, y, vx, vy, ax, ay, ux, uy; after the cycles the u rows
// hold the accepted start set, the records the accepted goal set)
__host__ __device__ constexpr int many_group_float4s(int m, bool box) { return (box ? 2 : 1) * m + 2 * m; }
__host__ __device__ constexpr size_t many_group_bytes(int m, bool box) {
  return 16 * static_cast<size_t>(many_group_float4s(m, box));
}

// Envs a block holds: 4, or 2 or 1 where that lets an SM hold more than a
// sixteenth more envs, by shared memory (233,472 bytes an SM, 1,024 of them
// reserved a block) and by registers (65,536 an SM, ``regs`` a thread
// allocated 256 a warp), at most 32 blocks and 64 warps an SM.  (Measured
// at 129 and 256 movers: one-env blocks that gained one warp an SM were 7%
// slower than four-env blocks; smaller blocks that gained a sixteenth or
// more were 2-8% faster.)
constexpr size_t kSmemPerSM = 233472;
__host__ __device__ constexpr int many_envs_per_block(int m, bool box, int regs) {
  const int warp_regs = (regs * 32 + 255) / 256 * 256;
  int best = 4, best_envs = 0;
  for (int envs = 4; envs >= 1; envs /= 2) {
    int blocks = static_cast<int>(kSmemPerSM / (envs * many_group_bytes(m, box) + 1024));
    blocks = blocks < 65536 / (envs * warp_regs) ? blocks : 65536 / (envs * warp_regs);
    blocks = blocks < 32 ? blocks : 32;
    blocks = blocks < 64 / envs ? blocks : 64 / envs;
    if (16 * envs * blocks > 17 * best_envs) {
      best = envs;
      best_envs = envs * blocks;
    }
  }
  return best;
}
// the shared memory of a block of ``envs`` envs
__host__ __device__ constexpr size_t many_smem_bytes(int m, bool box, int envs = 4) {
  return envs * many_group_bytes(m, box);
}

// The most movers a launch takes (the port's contract; a block of four
// envs holds 64 bytes a box mover, so shared memory is not what sets it).
constexpr size_t kMaxBlockSmem = 232448;
constexpr int kMaxMovers = 735;
static_assert(many_smem_bytes(kMaxMovers, true) <= kMaxBlockSmem, "a block of kMaxMovers box movers fits");

struct ManyConsts {
  const float* f;     // [kManyFields, M] in device memory
  const double* d64;  // [kMany64Rows, M] in device memory
  float min_goal_dist;
  int M;
  __device__ __forceinline__ float at(ManyField k, int i) const { return __ldg(f + k * M + i); }
  __device__ __forceinline__ double size64(int r, int i) const { return __ldg(d64 + r * M + i); }
};

// a group's pair records (see above)
struct ManyRecs {
  float4* a;
  float4* b;  // box only
  __device__ __forceinline__ void set_xy(int i, float x, float y) const {
    reinterpret_cast<float2*>(a)[2 * i] = make_float2(x, y);
  }
  __device__ __forceinline__ void set_zw(int i, float z, float w) const {
    reinterpret_cast<float2*>(a)[2 * i + 1] = make_float2(z, w);
  }
};

__device__ __forceinline__ double words_to_double(float lo, float hi) {
  return __hiloint2double(__float_as_int(hi), __float_as_int(lo));
}
__device__ __forceinline__ float4 doubles_to_words(double x, double y) {
  return make_float4(__int_as_float(__double2loint(x)), __int_as_float(__double2hiint(x)),
                     __int_as_float(__double2loint(y)), __int_as_float(__double2hiint(y)));
}
// the summed float64 sizes of two movers, rounded once
__device__ __forceinline__ float sum64(double a, double b) { return __double2float_rn(__dadd_rn(a, b)); }

// The pair tests: each loads a mover's record and flags a pair (p the lower
// mover, q the higher) as the slot variants test pair (i, j), i < j.
// A cycle's pair hits (circle: centre distance against the summed radii).
struct CircleHit {
  struct Rec {
    float x, y;
    double s;
  };
  __device__ __forceinline__ Rec load(const ManyRecs& r, int i) const {
    const float4 v = r.a[i];
    return {v.x, v.y, words_to_double(v.z, v.w)};
  }
  __device__ __forceinline__ bool operator()(const Rec& p, const Rec& q) const {
    return sqrtf(sq2(sub(p.x, q.x), sub(p.y, q.y))) <= sum64(p.s, q.s);
  }
};
// A start set's circle pair is too close at the summed sizes with the safety
// offset: the same test on the records' sampling sizes.
using CircleStartReject = CircleHit;

// A cycle's box pair hits: the SAT test on the quaternion-noised rotations.
struct BoxHit {
  struct Rec {
    float4 a, b;
  };
  __device__ __forceinline__ Rec load(const ManyRecs& r, int i) const { return {r.a[i], r.b[i]}; }
  __device__ __forceinline__ bool operator()(const Rec& p, const Rec& q) const {
    return rects_intersect_sat(sub(q.a.x, p.a.x), sub(q.a.y, p.a.y), Rot2{p.b.x, p.b.y, p.b.z, p.b.w}, p.a.z, p.a.w,
                               Rot2{q.b.x, q.b.y, q.b.z, q.b.w}, q.a.z, q.a.w);
  }
};

// A start set's box pair collides at the identity orientation.
struct BoxStartReject {
  struct Rec {
    float4 a;
    double sx, sy;
  };
  __device__ __forceinline__ Rec load(const ManyRecs& r, int i) const {
    const float4 b = r.b[i];
    return {r.a[i], words_to_double(b.x, b.y), words_to_double(b.z, b.w)};
  }
  __device__ __forceinline__ bool operator()(const Rec& p, const Rec& q) const {
    return rects_intersect_ident(sub(q.a.x, p.a.x), sub(q.a.y, p.a.y), p.a.z, p.a.w, q.a.z, q.a.w, sum64(p.sx, q.sx),
                                 sum64(p.sy, q.sy));
  }
};

// A goal set's pair is closer than min_goal_dist.
struct GoalReject {
  float min_goal_dist;
  using Rec = float2;
  __device__ __forceinline__ Rec load(const ManyRecs& r, int i) const {
    return reinterpret_cast<const float2*>(r.a)[2 * i];
  }
  __device__ __forceinline__ bool operator()(const Rec& p, const Rec& q) const {
    return !(sqrtf(sq2(sub(p.x, q.x), sub(p.y, q.y))) >= min_goal_dist);
  }
};

// Whether the test flags any pair (i, j), i < j, of the M movers' records
// (every lane returns the same).  kFirst: the walk ends at the first warp
// vote that sees a flag, one vote a pair (a candidate set, rejected by its
// first few pairs at many movers); else the lanes OR their flags and vote
// once at the end (a cycle, which rarely hits: a vote a pair took 23% more
// time there).  The order (mirrored by pair_schedule in
// ops/kernels/planning_multi.py): row i holds the pairs (i, i + 1 ... M - 1),
// and rows v and M - 2 - v together hold M pairs, a folded row; the
// V = (M - 1) / 2 folded rows, then (even M) row M / 2 - 1 alone, are pairs
// 0 ... M (M - 1) / 2 - 1, pair v M + s being (v, v + 1 + s) for
// s < M - 1 - v and (M - 2 - v, s) after.  In each of the first V / 32
// rounds lane l walks folded row 32 round + l alone, its lower mover in
// registers (M pairs, every lane alike); the pairs after those are dealt
// round-robin (lane l: l, l + 32, ...).  No loop carries across rows.
template <bool kFirst, class Test>
__device__ __forceinline__ bool walk_pairs(const ManyRecs& r, int M, int lane, const Test& test) {
  const int V = (M - 1) / 2, rounds = V / 32, n_pairs = num_pairs(M);
  bool flag = false;
  for (int t = 0; t < rounds; ++t) {
    const int a = 32 * t + lane;
    typename Test::Rec lo = test.load(r, a);
    int j = a;
    for (int s = 0; s < M; ++s) {
      if (j == M - 1) {  // row a is done: row M - 2 - a, from its first pair
        j = M - 1 - a;
        lo = test.load(r, M - 2 - a);
      } else {
        ++j;
      }
      flag |= test(lo, test.load(r, j));
      if (kFirst && __any_sync(0xffffffffu, flag)) return true;
    }
  }
  const int q0 = 32 * rounds * M;
  int v = (q0 + lane) / M, s = (q0 + lane) % M;
  for (int q = q0; q < n_pairs; q += 32) {
    if (q + lane < n_pairs) {
      const bool first = s < M - 1 - v;
      flag |= test(test.load(r, first ? v : M - 2 - v), test.load(r, first ? v + 1 + s : s));
    }
    if (kFirst && __any_sync(0xffffffffu, flag)) return true;
    for (s += 32; s >= M; s -= M) ++v;
  }
  return !kFirst && __any_sync(0xffffffffu, flag);
}

struct ManyEnv {
  const PlanningLaunch& L;
  const ManyConsts& mc;
  ManyRecs recs;
  float* s;  // this env's state [8, M]
  int64_t e;
  int M;
  bool full;
  int lane;
};

template <bool kBox>
__device__ __forceinline__ void many_cycles(const ManyEnv& ge, const Draws& dr, float& wall_f, float& mover_f) {
  const PlanningConsts& c = ge.L.c;
  const ManyConsts& mc = ge.mc;
  const int M = ge.M, p_w = kBox ? 3 : 1, n_draws = cycle_draws(M, kBox);
  const Rot2 ident = {1.0f, 0.0f, 0.0f, 1.0f};
  float* s = ge.s;
  // the cycle pair test's sizes, once
  for (int i = ge.lane; i < M; i += 32) {
    if (kBox) {
      ge.recs.set_zw(i, mc.at(kPairX, i), mc.at(kPairY, i));
    } else {
      const double d = mc.size64(0, i);
      ge.recs.set_zw(i, __int_as_float(__double2loint(d)), __int_as_float(__double2hiint(d)));
    }
  }
  wall_f = 0.0f;
  mover_f = 0.0f;
  for (int cyc = 0; cyc < ge.L.num_cycles; ++cyc) {
    const uint32_t d0 = static_cast<uint32_t>(cyc * n_draws);
    bool wall = false;
    for (int i = ge.lane; i < M; i += 32) {
      float px = s[i], py = s[M + i], vx = s[2 * M + i], vy = s[3 * M + i], ax = s[4 * M + i], ay = s[5 * M + i];
      const float ux = s[6 * M + i], uy = s[7 * M + i];
      float nvx, nvy;
      auto nv = dr.at(ge.e, d0 + 2 * i);
      normal_pair(nv, nvx, nvy);
      const float vmx = madd(vx, nvx, c.std_vel), vmy = madd(vy, nvy, c.std_vel);
      const float scale = mc.at(kAccelScale, i);
      const float amx = mul(scale, ax), amy = mul(scale, ay);
      float nax, nay;
      if (ge.L.jerk) {
        clamp_chain<true>(c.v_max, c.a_max, c.dt, vmx, vmy, ux, uy, amx, amy, ax, ay, nax, nay);
      } else {
        clamp_chain<false>(c.v_max, c.a_max, c.dt, vmx, vmy, ux, uy, amx, amy, ax, ay, nax, nay);
      }
      vx = madd(vx, c.dt, mul(scale, nax));
      vy = madd(vy, c.dt, mul(scale, nay));
      px = madd(px, c.dt, vx);
      py = madd(py, c.dt, vy);
      s[i] = px;
      s[M + i] = py;
      s[2 * M + i] = vx;
      s[3 * M + i] = vy;
      s[4 * M + i] = nax;
      s[5 * M + i] = nay;
      // the mover's wall check on its own pose noise and size
      float w[6], q[6];
      auto nw = dr.at(ge.e, d0 + static_cast<uint32_t>(2 * M + 2 * p_w * i));
#pragma unroll
      for (int k = 0; k < 2 * p_w; k += 2) normal_pair(nw, w[k], w[k + 1]);
      const Rot2 R = kBox ? rotation_of(w[2], w[3], w[4], w[5], c.std_pos) : ident;
      wall |= !multi_shape_valid<kBox>(ge.L, ge.full, madd(px, w[0], c.std_pos), madd(py, w[1], c.std_pos), R,
                                       mc.at(kWallX, i), mc.at(kWallY, i));
      // a second, independent noisy pose for the pair tests
      auto nq = dr.at(ge.e, d0 + static_cast<uint32_t>(2 * M + 2 * p_w * M + 2 * p_w * i));
#pragma unroll
      for (int k = 0; k < 2 * p_w; k += 2) normal_pair(nq, q[k], q[k + 1]);
      ge.recs.set_xy(i, madd(px, q[0], c.std_pos), madd(py, q[1], c.std_pos));
      if (kBox) {
        const Rot2 Rq = rotation_of(q[2], q[3], q[4], q[5], c.std_pos);
        ge.recs.b[i] = make_float4(Rq.r00, Rq.r01, Rq.r10, Rq.r11);
      }
    }
    __syncwarp();
    const bool hit = kBox ? walk_pairs<false>(ge.recs, M, ge.lane, BoxHit{})
                          : walk_pairs<false>(ge.recs, M, ge.lane, CircleHit{});
    const bool any_wall = __any_sync(0xffffffffu, wall);
    __syncwarp();  // this cycle's record reads before the next cycle's writes
    if (any_wall | hit) {  // latched: the state is frozen for the remaining cycles
      wall_f = any_wall ? 1.0f : 0.0f;
      mover_f = hit ? 1.0f : 0.0f;
      break;
    }
  }
}

// group_sample of the slot variants with the movers walked by the lanes: the
// set's positions go to the records' x, y, the pair tests' sizes once to
// the rest; an accepted start set is kept in keep [2, M] (x row, then y row),
// an accepted goal set stays in the records.
template <bool kBox, bool kGoal>
__device__ __forceinline__ bool many_sample(const ManyEnv& ge, const Draws& dr, uint32_t d_set, float* keep,
                                            float& trials) {
  const PlanningConsts& c = ge.L.c;
  const ManyConsts& mc = ge.mc;
  const int M = ge.M;
  const Rot2 ident = {1.0f, 0.0f, 0.0f, 1.0f};
  if (!kGoal) {
    for (int i = ge.lane; i < M; i += 32) {
      if (kBox) {
        ge.recs.set_zw(i, mc.at(kSamplePairX, i), mc.at(kSamplePairY, i));
        ge.recs.b[i] = doubles_to_words(mc.size64(1, i), mc.size64(2, i));
      } else {
        const double d = mc.size64(1, i);
        ge.recs.set_zw(i, __int_as_float(__double2loint(d)), __int_as_float(__double2hiint(d)));
      }
    }
  }
  for (int k = 0; k < ge.L.cand_k; ++k) {
    bool ok = true;
    for (int i = ge.lane; i < M; i += 32) {
      auto n = dr.at(ge.e, d_set + static_cast<uint32_t>(2 * M * k + 2 * i));
      const float cx = uniform_in(n, c.min_x, c.span_x);
      const float cy = uniform_in(n, c.min_y, c.span_y);
      ok &= multi_shape_valid<kBox>(ge.L, ge.full, cx, cy, ident, mc.at(kSampleX, i), mc.at(kSampleY, i));
      ge.recs.set_xy(i, cx, cy);
    }
    __syncwarp();
    // a set some mover's wall check rejects skips its pair walk
    bool rejected = __any_sync(0xffffffffu, !ok);
    if (!rejected) {
      if (kGoal) {
        rejected = walk_pairs<true>(ge.recs, M, ge.lane, GoalReject{mc.min_goal_dist});
      } else if (kBox) {
        rejected = walk_pairs<true>(ge.recs, M, ge.lane, BoxStartReject{});
      } else {
        rejected = walk_pairs<true>(ge.recs, M, ge.lane, CircleStartReject{});
      }
    }
    __syncwarp();  // this set's reads before the next writes
    if (!rejected) {
      if (!kGoal) {
        for (int i = ge.lane; i < M; i += 32) {
          const float2 p = GoalReject{}.load(ge.recs, i);
          keep[i] = p.x;
          keep[M + i] = p.y;
        }
      }
      trials = static_cast<float>(k + 1);
      return true;
    }
  }
  trials = static_cast<float>(ge.L.cand_k);
  return false;
}

// group_step of the slot variants (the same output planes and draws) with
// the movers in shared memory.  The pre-reset observation is read back from
// the output planes the lane wrote, where the env carries on.
template <bool kBox>
__device__ __forceinline__ void many_step(const ManyEnv& ge, const Draws& dr, const float* __restrict__ st_in,
                                          const float* __restrict__ act, float* __restrict__ out, int64_t B) {
  const PlanningConsts& c = ge.L.c;
  const int M = ge.M;
  const int64_t e = ge.e;
  float* s = ge.s;
  for (int i = ge.lane; i < M; i += 32) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {  // x, y, vx, vy, ax, ay
      s[k * M + i] = st_in[(2 * (k / 2) * M + 2 * i + (k & 1)) * B + e];
    }
    s[6 * M + i] = act[(2 * i) * B + e];
    s[7 * M + i] = act[(2 * i + 1) * B + e];
  }
  const float steps = st_in[(8 * M) * B + e];
  float wall_f, mover_f;
  many_cycles<kBox>(ge, dr, wall_f, mover_f);

  // pre-reset observation and the goals reached within the noisy threshold
  const uint32_t d_obs = static_cast<uint32_t>(ge.L.num_cycles * cycle_draws(M, kBox));
  float* o = out + (8 * M + 1) * B + e;
  unsigned unreached = 0;
  for (int i = ge.lane; i < M; i += 32) {
    auto n = dr.at(e, d_obs + 4 * i);
    float n1, n2, n3, n4;
    normal_pair(n, n1, n2);
    normal_pair(n, n3, n4);
    const float fagx = madd(s[i], n1, c.std_pos), fagy = madd(s[M + i], n2, c.std_pos);
    const float fvx = madd(s[2 * M + i], n3, c.std_vel), fvy = madd(s[3 * M + i], n4, c.std_vel);
    const float ddx = sub(fagx, st_in[(6 * M + 2 * i) * B + e]), ddy = sub(fagy, st_in[(6 * M + 2 * i + 1) * B + e]);
    unreached += sqrtf(sq2(ddx, ddy)) <= c.threshold ? 0u : 1u;
    o[(4 * M + 2 * i) * B] = fvx;
    o[(4 * M + 2 * i + 1) * B] = fvy;
    o[(6 * M + 2 * i) * B] = fagx;
    o[(6 * M + 2 * i + 1) * B] = fagy;
    o[(8 * M + 2 * i) * B] = s[4 * M + i];  // pre-reset act (jerk-mode final observation)
    o[(8 * M + 2 * i + 1) * B] = s[5 * M + i];
  }
  const float num_unreached = static_cast<float>(__reduce_add_sync(0xffffffffu, unreached));
  const bool collided = (wall_f > 0.0f) | (mover_f > 0.0f);
  const bool term = collided | (num_unreached == 0.0f);
  const float new_steps = add(steps, 1.0f);
  const bool trunc = new_steps >= c.max_episode_steps;
  const bool done = term | trunc;

  // restart: start sets (kept in the u rows, free after the cycles), then
  // goal sets (kept in the records); an env that is not done reads none
  const uint32_t d_starts = d_obs + 4 * M;
  const uint32_t d_goals = d_starts + static_cast<uint32_t>(2 * M * ge.L.cand_k);
  float s_trials = 0.0f, g_trials = 0.0f;
  bool found = false;
  if (done) {
    const bool s_found = many_sample<kBox, false>(ge, dr, d_starts, s + 6 * M, s_trials);
    const bool g_found = many_sample<kBox, true>(ge, dr, d_goals, nullptr, g_trials);
    found = s_found & g_found;
  }
  const bool do_reset = done & found;
  const uint32_t d_post = d_goals + static_cast<uint32_t>(2 * M * ge.L.cand_k);
  for (int i = ge.lane; i < M; i += 32) {
    float px = s[i], py = s[M + i], vx = s[2 * M + i], vy = s[3 * M + i], ax = s[4 * M + i], ay = s[5 * M + i];
    float gx = st_in[(6 * M + 2 * i) * B + e], gy = st_in[(6 * M + 2 * i + 1) * B + e];
    float svx, svy, sagx, sagy;
    if (do_reset) {
      px = s[6 * M + i];
      py = s[7 * M + i];
      vx = vy = ax = ay = 0.0f;
      const float2 g = GoalReject{}.load(ge.recs, i);
      gx = g.x;
      gy = g.y;
      auto n = dr.at(e, d_post + 4 * i);
      float m1, m2, m3, m4;
      normal_pair(n, m1, m2);
      normal_pair(n, m3, m4);
      sagx = madd(px, m1, c.std_pos);
      sagy = madd(py, m2, c.std_pos);
      svx = madd(vx, m3, c.std_vel);
      svy = madd(vy, m4, c.std_vel);
    } else {  // the pre-reset observation this lane wrote above
      svx = o[(4 * M + 2 * i) * B];
      svy = o[(4 * M + 2 * i + 1) * B];
      sagx = o[(6 * M + 2 * i) * B];
      sagy = o[(6 * M + 2 * i + 1) * B];
    }
    o[(2 * i) * B] = svx;
    o[(2 * i + 1) * B] = svy;
    o[(2 * M + 2 * i) * B] = sagx;
    o[(2 * M + 2 * i + 1) * B] = sagy;
    out[(2 * i) * B + e] = px;
    out[(2 * i + 1) * B + e] = py;
    out[(2 * M + 2 * i) * B + e] = vx;
    out[(2 * M + 2 * i + 1) * B + e] = vy;
    out[(4 * M + 2 * i) * B + e] = ax;
    out[(4 * M + 2 * i + 1) * B + e] = ay;
    out[(6 * M + 2 * i) * B + e] = gx;
    out[(6 * M + 2 * i + 1) * B + e] = gy;
  }
  if (ge.lane == 0) {
    out[(8 * M) * B + e] = do_reset ? 0.0f : new_steps;
    o[(10 * M + 0) * B] = wall_f;
    o[(10 * M + 1) * B] = mover_f;
    o[(10 * M + 2) * B] = num_unreached;
    o[(10 * M + 3) * B] = (done & !found) ? 1.0f : 0.0f;
    o[(10 * M + 4) * B] = done ? add(s_trials, g_trials) : 0.0f;
  }
}

// One block of many_envs_per_block(M) warps, one env a warp: each warp runs
// its env's step on its part of the block's shared memory.
template <bool kBox>
__global__ void __launch_bounds__(kThreads)
    planning_multi_many_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                               const float* __restrict__ noise, float* __restrict__ out, int64_t B,
                               const PlanningLaunch Lc, const float* __restrict__ consts,
                               const double* __restrict__ sizes64, int M, bool full, Seed seed) {
  extern __shared__ float4 smem4[];
  const int gib = threadIdx.x / 32;  // the env's warp in the block
  const int64_t e = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + gib;
  if (e >= B) return;  // a whole warp
  float4* group = smem4 + gib * many_group_float4s(M, kBox);
  const ManyConsts mc{consts, sizes64, __ldg(consts + multi_const_floats(M) - 1), M};  // min_goal_dist: the last
  const int lane = static_cast<int>(threadIdx.x % 32);
  const ManyEnv ge{Lc, mc, ManyRecs{group, kBox ? group + M : nullptr},
                   reinterpret_cast<float*>(group + (kBox ? 2 : 1) * M), e, M, full, lane};
  many_step<kBox>(ge, Draws{noise, B, noise == nullptr ? seed.get() : 0}, st_in, act, out, B);
}

// Host side: launch the many-mover variant with one collision shape.
template <bool kBox>
cudaError_t launch_planning_multi_many(const float* st, const float* act, const float* noise, float* out, int64_t B,
                                       const PlanningLaunch& Lc, const float* consts, const double* sizes64, int M,
                                       bool full, Seed seed, cudaStream_t s) {
  auto kernel = planning_multi_many_kernel<kBox>;
  static const int regs = [&] {  // the instantiation's registers a thread, read once
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs : 255;
  }();
  const int envs = many_envs_per_block(M, kBox, regs);
  const size_t smem = many_smem_bytes(M, kBox, envs);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned int>((B + envs - 1) / envs), 32 * envs, smem, s>>>(st, act, noise, out, B, Lc, consts,
                                                                                 sizes64, M, full, seed);
  return cudaGetLastError();
}

}  // namespace gprt
