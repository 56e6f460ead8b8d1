// Kernel G: K single-mover planning autoreset env steps in one launch.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_rollout_kernel, reached from
// make_fused_planning_autoreset_cycles.raw_rollout.
//
// Bound on an H100: kernel F's per-env arithmetic, K times; the state stays
// in registers across the K steps, so per step only the two action planes
// are read and three signal planes written (20 B per env and step).
// Design: kernel F's step function in a loop over K inside the thread; one
// Philox stream per env runs on across the K steps (the launch seed keys
// it).  The injected mode reads K consecutive blocks of kernel F's noise
// planes, so the kernel can be held against K plain steps.

#include "planning.cuh"

namespace gprt {

template <bool kBox, bool kFull, class Noise>
__device__ void planning_rollout_body(const PlanningLaunch& L, Noise& noise, PlanningState& st,
                                      const float* __restrict__ actions, float* __restrict__ step_out, int64_t B,
                                      int64_t e, int K) {
  for (int t = 0; t < K; ++t) {
    const float ux = actions[(2 * static_cast<int64_t>(t)) * B + e];
    const float uy = actions[(2 * static_cast<int64_t>(t) + 1) * B + e];
    PlanningAux aux;
    planning_autoreset_step<kBox, kFull>(L, noise, st, ux, uy, aux);
    step_out[(0 * static_cast<int64_t>(K) + t) * B + e] = aux.wall;
    step_out[(1 * static_cast<int64_t>(K) + t) * B + e] = aux.reached;
    step_out[(2 * static_cast<int64_t>(K) + t) * B + e] = aux.trunc;
  }
}

template <bool kBox, bool kFull, bool kInject>
__global__ void __launch_bounds__(kThreads)
    planning_rollout_kernel(const float* __restrict__ st_in, const float* __restrict__ actions,
                            const float* __restrict__ noise, float* __restrict__ st_out,
                            float* __restrict__ step_out, int64_t B, int K, const PlanningLaunch L, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  PlanningState st;
  load_planning_state(st_in, B, e, st);
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    planning_rollout_body<kBox, kFull>(L, n, st, actions, step_out, B, e, K);
  } else {
    PhiloxNoise n(seed, e);
    planning_rollout_body<kBox, kFull>(L, n, st, actions, step_out, B, e, K);
  }
  store_planning_state(st_out, B, e, st);
}

template <bool kBox, bool kFull, bool kInject>
struct RolloutBody {
  static void launch(const float* st, const float* actions, const float* noise, float* st_out, float* step_out,
                     int64_t B, int K, const PlanningLaunch& L, Seed seed, cudaStream_t s) {
    planning_rollout_kernel<kBox, kFull, kInject>
        <<<num_blocks(B), kThreads, 0, s>>>(st, actions, noise, st_out, step_out, B, K, L, seed);
  }
};

}  // namespace gprt

// st: [9, B]; actions: [K, 2, B]; noise: [K * ((2 + 2p) * num_cycles + 8 +
// 4 * cand_k), B] uniforms or null for Philox; st_out: [9, B]; step_out:
// [3, K, B] (wall, reached, trunc per step).
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh).
extern "C" int gprt_planning_rollout(const float* st, const float* actions, const float* noise, float* st_out,
                                     float* step_out, int64_t B, int K, const void* consts, const float* table,
                                     int n_cells, int box, int full, int jerk, int num_cycles, int cand_k,
                                     uint64_t seed_value, const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0 || K <= 0) return 0;
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, cand_k);
  dispatch_planning<RolloutBody>(box != 0, full != 0, noise != nullptr, st, actions, noise, st_out, step_out, B, K,
                                 L, seed, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
