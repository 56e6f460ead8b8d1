// Kernel C: one pushing autoreset env step, optionally with the two policy
// feature blocks (C-feat).
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _pushing_autoreset_kernel (body _pushing_autoreset_step), reached from
// make_fused_pushing_autoreset_cycles; the emit_features variant
// (pallas_step.py:1066-1078) feeds the reactive rollout.  Each comes in the
// circle and the box collision shape (kBox).
//
// Bound on an H100: arithmetic per env (kernel B's cycles, plus 12 normals
// and 2*cand_k + 4 uniforms for the observations and the restart); bytes
// are small: 21 planes in and 36 out per env and step (~230 B, ~0.9 MB at
// 4096 envs), 24 more out with the features.  Design: one thread per env;
// the restart's candidate loop runs in registers and keeps the first
// accepted candidate, so no candidate array is materialised.  Output order
// is the Pallas raw_planes contract: 19 state planes, post-reset obs (6),
// pre-reset obs (8), wall, stalled, trials.  The feature blocks are written
// from the same registers after the step, so emitting them changes neither
// the 36 planes nor the draws.

#include "pushing.cuh"

namespace gprt {

__device__ __forceinline__ void store_aux(float* out, int64_t B, int64_t e, const StepAux& a) {
  float* o = out + 19 * B + e;
  o[0 * B] = a.s_mpx; o[1 * B] = a.s_mpy; o[2 * B] = a.s_mvx; o[3 * B] = a.s_mvy;
  o[4 * B] = a.s_agx; o[5 * B] = a.s_agy;
  o[6 * B] = a.f_mpx; o[7 * B] = a.f_mpy; o[8 * B] = a.f_mvx; o[9 * B] = a.f_mvy;
  o[10 * B] = a.f_agx; o[11 * B] = a.f_agy; o[12 * B] = a.f_qax; o[13 * B] = a.f_qay;
  o[14 * B] = a.wall; o[15 * B] = a.stalled; o[16 * B] = a.trials;
}

// One [12, B] feature block at f (the training recipes' layout): mover pos
// and vel, achieved, goal, achieved - mover, goal - achieved.
__device__ __forceinline__ void store_features(float* f, int64_t B, float mpx, float mpy, float mvx, float mvy,
                                               float agx, float agy, float gx, float gy) {
  f[0 * B] = mpx; f[1 * B] = mpy; f[2 * B] = mvx; f[3 * B] = mvy;
  f[4 * B] = agx; f[5 * B] = agy; f[6 * B] = gx; f[7 * B] = gy;
  f[8 * B] = agx - mpx; f[9 * B] = agy - mpy; f[10 * B] = gx - agx; f[11 * B] = gy - agy;
}

template <bool kJerk, bool kBox, bool kInject, bool kEmit>
__global__ void __launch_bounds__(kThreads)
    pushing_autoreset_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                             const float* __restrict__ noise, float* __restrict__ out, float* __restrict__ feat,
                             int64_t B, const Consts c, int num_cycles, int cand_k, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  StepState st;
  load_state(st_in, B, e, st);
  const float g_old_x = st.gx, g_old_y = st.gy;
  const float ux = act[e], uy = act[B + e];
  StepAux aux;
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    autoreset_step<kJerk, kBox>(c, n, num_cycles, cand_k, st, ux, uy, aux);
  } else {
    PhiloxNoise n(seed, e);
    autoreset_step<kJerk, kBox>(c, n, num_cycles, cand_k, st, ux, uy, aux);
  }
  store_state(out, B, e, st);
  store_aux(out, B, e, aux);
  if constexpr (kEmit) {
    // feat [2, 12, B]: block 0 the post-reset observation with the
    // (possibly new) goal, block 1 the pre-reset one with the old goal
    store_features(feat + e, B, aux.s_mpx, aux.s_mpy, aux.s_mvx, aux.s_mvy, aux.s_agx, aux.s_agy, st.gx, st.gy);
    store_features(feat + 12 * B + e, B, aux.f_mpx, aux.f_mpy, aux.f_mvx, aux.f_mvy, aux.f_agx, aux.f_agy, g_old_x,
                   g_old_y);
  }
}

template <bool kJerk, bool kBox, bool kEmit>
void launch_by_noise(const float* st, const float* act, const float* noise, float* out, float* feat, int64_t B,
                     const Consts& c, int num_cycles, int cand_k, Seed seed, cudaStream_t s) {
  if (noise != nullptr) {
    pushing_autoreset_kernel<kJerk, kBox, true, kEmit>
        <<<num_blocks(B), kThreads, 0, s>>>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed);
  } else {
    pushing_autoreset_kernel<kJerk, kBox, false, kEmit>
        <<<num_blocks(B), kThreads, 0, s>>>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed);
  }
}

template <bool kJerk, bool kBox>
void launch_autoreset(const float* st, const float* act, const float* noise, float* out, float* feat, int64_t B,
                      const Consts& c, int num_cycles, int cand_k, Seed seed, cudaStream_t s) {
  if (feat != nullptr) {
    launch_by_noise<kJerk, kBox, true>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, s);
  } else {
    launch_by_noise<kJerk, kBox, false>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, s);
  }
}

}  // namespace gprt

// st: [19, B] state planes; act: [2, B]; noise: [(2 + 2p)*num_cycles + 16 +
// 2*cand_k, B] uniforms (p = 1 circle, 3 box) or null for Philox; out:
// [36, B]; feat: [2, 12, B] feature blocks, or null for none.  The Philox
// seed is *seed_dev when seed_dev (device memory) is not null, else
// seed_value.
extern "C" int gprt_pushing_autoreset(const float* st, const float* act, const float* noise, float* out, float* feat,
                                      int64_t B, const void* consts, int num_cycles, int cand_k, int learn_jerk,
                                      int box, uint64_t seed_value, const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (learn_jerk) {
    (box ? launch_autoreset<true, true> : launch_autoreset<true, false>)(st, act, noise, out, feat, B, c,
                                                                         num_cycles, cand_k, seed, s);
  } else {
    (box ? launch_autoreset<false, true> : launch_autoreset<false, false>)(st, act, noise, out, feat, B, c,
                                                                           num_cycles, cand_k, seed, s);
  }
  return static_cast<int>(cudaGetLastError());
}
