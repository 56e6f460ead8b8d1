// Kernel G: K single-mover planning autoreset env steps in one launch.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_rollout_kernel, reached from
// make_fused_planning_autoreset_cycles.raw_rollout.
//
// Bound on an H100: kernel F's per-env arithmetic, K times; the state stays
// in registers across the K steps, so per step only the two action planes
// are read and three signal planes written (20 B per env and step).
// Design: kernel F's blocks (planning.cuh, planning_body) over K steps: the
// consumer keeps each env's state in registers for the whole launch while
// the producer runs ahead through the K steps' noise and restarts; above
// planning's WIDE_BATCH, thread-per-env blocks.  One Philox stream per env
// runs on across the K steps (the launch seed keys it; step t's draws start
// at t * n_step).  The injected mode reads K consecutive blocks of kernel
// F's noise planes, so the kernel can be held against K plain steps.

#include "planning.cuh"

namespace gprt {

// the state planes in; the K steps' signals and the final state out
struct RolloutOut {
  const float* st_in;
  float* st_out;
  float* step_out;
  int64_t B;
  int K;
  __device__ void load(int64_t e, PlanningState& st) const { load_planning_state(st_in, B, e, st); }
  __device__ void step(int64_t e, int t, const PlanningState&, const PlanningAux& aux) {
    step_out[(0 * static_cast<int64_t>(K) + t) * B + e] = aux.wall;
    step_out[(1 * static_cast<int64_t>(K) + t) * B + e] = aux.reached;
    step_out[(2 * static_cast<int64_t>(K) + t) * B + e] = aux.trunc;
  }
  __device__ void finish(int64_t e, const PlanningState& st) { store_planning_state(st_out, B, e, st); }
};

template <bool kBox, bool kFull, bool kInject, bool kProducer>
__global__ void __launch_bounds__(kPlanningMaxThreads)
    planning_rollout_kernel(const float* __restrict__ st_in, const float* __restrict__ actions,
                            const float* __restrict__ noise, float* __restrict__ st_out,
                            float* __restrict__ step_out, int64_t B, int K, const PlanningLaunch L, Seed seed) {
  RolloutOut o{st_in, st_out, step_out, B, K};
  if constexpr (kInject) {
    planning_body<kBox, kFull, kProducer, Steps::kAutoreset>(L, InjectedSource{noise, B}, actions, B, K, o);
  } else {
    planning_body<kBox, kFull, kProducer, Steps::kAutoreset>(L, PhiloxSource{seed.get()}, actions, B, K, o);
  }
}

template <bool kBox, bool kFull, bool kInject>
struct RolloutBody {
  static void launch(const float* st, const float* actions, const float* noise, float* st_out, float* step_out,
                     int64_t B, int K, const PlanningLaunch& L, Seed seed, bool producer, cudaStream_t s) {
    const auto kernel = producer ? planning_rollout_kernel<kBox, kFull, kInject, true>
                                 : planning_rollout_kernel<kBox, kFull, kInject, false>;
    launch_planning(kernel, producer, B, s, st, actions, noise, st_out, step_out, B, K, L, seed);
  }
};

}  // namespace gprt

// st: [9, B]; actions: [K, 2, B]; noise: [K * ((2 + 2p) * num_cycles + 8 +
// 4 * cand_k), B] uniforms or null for Philox; st_out: [9, B]; step_out:
// [3, K, B] (wall, reached, trunc per step).
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh); producer:
// 1 for blocks with the producer (planning.cuh, kPlanningProducers warps), 0
// for thread-per-env blocks.
extern "C" int gprt_planning_rollout(const float* st, const float* actions, const float* noise, float* st_out,
                                     float* step_out, int64_t B, int K, const void* consts, const float* table,
                                     int n_cells, int box, int full, int jerk, int num_cycles, int cand_k,
                                     uint64_t seed_value, const int64_t* seed_dev, int producer, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0 || K <= 0) return 0;
  if (producer != 0 && producer != 1) return static_cast<int>(cudaErrorInvalidValue);
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, cand_k);
  dispatch_planning<RolloutBody>(box != 0, full != 0, noise != nullptr, st, actions, noise, st_out, step_out, B, K,
                                 L, seed, producer != 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
