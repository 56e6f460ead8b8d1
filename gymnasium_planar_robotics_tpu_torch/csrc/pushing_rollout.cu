// Kernel D: K pushing autoreset env steps in one launch.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _pushing_rollout_kernel, reached from make_fused_pushing_autoreset_cycles
// .raw_rollout, for the circle and the box collision shape (kBox).
//
// Bound on an H100: the same per-env arithmetic as kernel C, K times; the
// state stays in registers across the K steps, so per step only the two
// action planes are read and three signal planes written (20 B per env).
// Design: kernel C's producer/consumer blocks (pushing.cuh, split_body)
// over K steps: the consumer keeps each env's state in registers for the
// whole launch while the producer runs ahead through the K steps' draws.
// One Philox stream per env runs on across the K steps (the launch seed
// keys it; step t's draws start at t * n_step).  The injected mode reads K
// consecutive blocks of kernel C's noise planes, so the kernel can be held
// against K plain steps.

#include "pushing.cuh"

namespace gprt {

// the state planes in; the K steps' signals and the final state out
struct RolloutOut {
  const float* st_in;
  float* st_out;
  float* step_out;
  int64_t B;
  int K;
  __device__ void load(int64_t e, StepState& st) const { load_state(st_in, B, e, st); }
  __device__ void step(int64_t e, int t, const StepState&, const StepAux& aux, float, float) {
    step_out[(0 * static_cast<int64_t>(K) + t) * B + e] = aux.wall;
    step_out[(1 * static_cast<int64_t>(K) + t) * B + e] = aux.reached;
    step_out[(2 * static_cast<int64_t>(K) + t) * B + e] = aux.trunc;
  }
  __device__ void finish(int64_t e, const StepState& st) { store_state(st_out, B, e, st); }
};

template <bool kJerk, bool kBox, bool kInject>
__global__ void __launch_bounds__(kSplitMaxThreads)
    pushing_rollout_kernel(const float* __restrict__ st_in, const float* __restrict__ actions,
                           const float* __restrict__ noise, float* __restrict__ st_out, float* __restrict__ step_out,
                           int64_t B, int K, const Consts c, int num_cycles, int cand_k, Seed seed, bool producer) {
  RolloutOut o{st_in, st_out, step_out, B, K};
  if constexpr (kInject) {
    split_body<kJerk, kBox, Steps::kAutoreset>(c, InjectedSource{noise, B}, actions, B, K, num_cycles, cand_k,
                                               producer, o);
  } else {
    split_body<kJerk, kBox, Steps::kAutoreset>(c, PhiloxSource{seed.get()}, actions, B, K, num_cycles, cand_k,
                                               producer, o);
  }
}

template <bool kJerk, bool kBox, bool kInject>
void launch_split(const float* st, const float* actions, const float* noise, float* st_out, float* step_out,
                  int64_t B, int K, const Consts& c, int num_cycles, int cand_k, Seed seed, bool producer,
                  cudaStream_t s) {
  constexpr auto kernel = pushing_rollout_kernel<kJerk, kBox, kInject>;
  kernel<<<split_blocks(producer, B), split_threads(producer), split_shared_bytes(producer), s>>>(
      st, actions, noise, st_out, step_out, B, K, c, num_cycles, cand_k, seed, producer);
}

template <bool kJerk, bool kBox>
void launch_rollout(const float* st, const float* actions, const float* noise, float* st_out, float* step_out,
                    int64_t B, int K, const Consts& c, int num_cycles, int cand_k, Seed seed, bool producer,
                    cudaStream_t s) {
  if (noise != nullptr) {
    launch_split<kJerk, kBox, true>(st, actions, noise, st_out, step_out, B, K, c, num_cycles, cand_k, seed,
                                    producer, s);
  } else {
    launch_split<kJerk, kBox, false>(st, actions, noise, st_out, step_out, B, K, c, num_cycles, cand_k, seed,
                                     producer, s);
  }
}

}  // namespace gprt

// st: [19, B]; actions: [K, 2, B]; noise: [K * ((2 + 2p)*num_cycles + 16 +
// 2*cand_k), B] uniforms (p = 1 circle, 3 box) or null for Philox; st_out:
// [19, B]; step_out: [3, K, B] (wall, reached, trunc per step);
// producer: 1 for blocks with the producer warp, 0 for blocks whose every
// warp draws its own values.  The Philox seed is *seed_dev when seed_dev
// (device memory) is not null, else seed_value.
extern "C" int gprt_pushing_rollout(const float* st, const float* actions, const float* noise, float* st_out,
                                    float* step_out, int64_t B, int K, const void* consts, int num_cycles, int cand_k,
                                    int learn_jerk, int box, uint64_t seed_value, const int64_t* seed_dev,
                                    int producer, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0 || K <= 0) return 0;
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (producer != 0 && producer != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (learn_jerk) {
    (box ? launch_rollout<true, true> : launch_rollout<true, false>)(st, actions, noise, st_out, step_out, B, K, c,
                                                                     num_cycles, cand_k, seed, producer, s);
  } else {
    (box ? launch_rollout<false, true> : launch_rollout<false, false>)(st, actions, noise, st_out, step_out, B, K, c,
                                                                       num_cycles, cand_k, seed, producer, s);
  }
  return static_cast<int>(cudaGetLastError());
}
