// Kernel D: K pushing autoreset env steps in one launch.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _pushing_rollout_kernel, reached from make_fused_pushing_autoreset_cycles
// .raw_rollout, for the circle and the box collision shape (kBox).
//
// Bound on an H100: the same per-env arithmetic as kernel C, K times; the
// state stays in registers across the K steps, so per step only the two
// action planes are read and three signal planes written (20 B per env).
// Design: kernel C's step function in a loop over K inside the thread; one
// Philox stream per env runs on across the K steps (the launch seed keys
// it).  The injected mode reads K consecutive blocks of kernel C's noise
// planes, so the kernel can be held against K plain steps.

#include "pushing.cuh"

namespace gprt {

template <bool kJerk, bool kBox, class Noise>
__device__ void rollout_body(const Consts& c, Noise& noise, int num_cycles, int cand_k, StepState& st,
                             const float* __restrict__ actions, float* __restrict__ step_out, int64_t B, int64_t e,
                             int K) {
  for (int t = 0; t < K; ++t) {
    const float ux = actions[(2 * static_cast<int64_t>(t)) * B + e];
    const float uy = actions[(2 * static_cast<int64_t>(t) + 1) * B + e];
    StepAux aux;
    autoreset_step<kJerk, kBox>(c, noise, num_cycles, cand_k, st, ux, uy, aux);
    step_out[(0 * static_cast<int64_t>(K) + t) * B + e] = aux.wall;
    step_out[(1 * static_cast<int64_t>(K) + t) * B + e] = aux.reached;
    step_out[(2 * static_cast<int64_t>(K) + t) * B + e] = aux.trunc;
  }
}

template <bool kJerk, bool kBox, bool kInject>
__global__ void __launch_bounds__(kThreads)
    pushing_rollout_kernel(const float* __restrict__ st_in, const float* __restrict__ actions,
                           const float* __restrict__ noise, float* __restrict__ st_out, float* __restrict__ step_out,
                           int64_t B, int K, const Consts c, int num_cycles, int cand_k, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  StepState st;
  load_state(st_in, B, e, st);
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    rollout_body<kJerk, kBox>(c, n, num_cycles, cand_k, st, actions, step_out, B, e, K);
  } else {
    PhiloxNoise n(seed, e);
    rollout_body<kJerk, kBox>(c, n, num_cycles, cand_k, st, actions, step_out, B, e, K);
  }
  store_state(st_out, B, e, st);
}

template <bool kJerk, bool kBox>
void launch_rollout(const float* st, const float* actions, const float* noise, float* st_out, float* step_out,
                    int64_t B, int K, const Consts& c, int num_cycles, int cand_k, Seed seed, cudaStream_t s) {
  if (noise != nullptr) {
    pushing_rollout_kernel<kJerk, kBox, true>
        <<<num_blocks(B), kThreads, 0, s>>>(st, actions, noise, st_out, step_out, B, K, c, num_cycles, cand_k, seed);
  } else {
    pushing_rollout_kernel<kJerk, kBox, false>
        <<<num_blocks(B), kThreads, 0, s>>>(st, actions, noise, st_out, step_out, B, K, c, num_cycles, cand_k, seed);
  }
}

}  // namespace gprt

// st: [19, B]; actions: [K, 2, B]; noise: [K * ((2 + 2p)*num_cycles + 16 +
// 2*cand_k), B] uniforms (p = 1 circle, 3 box) or null for Philox; st_out:
// [19, B]; step_out: [3, K, B] (wall, reached, trunc per step).  The Philox
// seed is *seed_dev when seed_dev (device memory) is not null, else
// seed_value.
extern "C" int gprt_pushing_rollout(const float* st, const float* actions, const float* noise, float* st_out,
                                    float* step_out, int64_t B, int K, const void* consts, int num_cycles, int cand_k,
                                    int learn_jerk, int box, uint64_t seed_value, const int64_t* seed_dev,
                                    void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0 || K <= 0) return 0;
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (learn_jerk) {
    (box ? launch_rollout<true, true> : launch_rollout<true, false>)(st, actions, noise, st_out, step_out, B, K, c,
                                                                     num_cycles, cand_k, seed, s);
  } else {
    (box ? launch_rollout<false, true> : launch_rollout<false, false>)(st, actions, noise, st_out, step_out, B, K, c,
                                                                       num_cycles, cand_k, seed, s);
  }
  return static_cast<int>(cudaGetLastError());
}
