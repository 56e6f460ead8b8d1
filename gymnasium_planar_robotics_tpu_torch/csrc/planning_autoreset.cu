// Kernel F: one single-mover planning autoreset env step.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_autoreset_kernel (body _planning_autoreset_step), reached from
// make_fused_planning_autoreset_cycles.
//
// Bound on an H100: arithmetic and latency per env.  Kernel E's cycles, four
// normal pairs for the observations, and for the envs that are done two
// first-accepted samplers of up to cand_k wall-checked candidates each.
// Bytes are small: 11 planes in and 23 out per env (136 B, 0.56 MB at 4096
// envs, ~0.17 us of HBM time).  Design: one thread per env; a sampler stops
// checking at its first accepted candidate and an env that is not done
// passes over the sampling draws unread (skip() keeps the noise stream in
// place), so the restart costs only where it is used.  Output order is the
// Pallas raw_planes contract: 9 state planes, post-reset obs (vel x/y,
// achieved x/y), pre-reset obs (vel x/y, achieved x/y, act x/y), wall,
// reached, stalled, trials.

#include "planning.cuh"

namespace gprt {

__device__ __forceinline__ void store_planning_aux(float* out, int64_t B, int64_t e, const PlanningAux& a) {
  float* o = out + 9 * B + e;
  o[0 * B] = a.s_vx; o[1 * B] = a.s_vy; o[2 * B] = a.s_agx; o[3 * B] = a.s_agy;
  o[4 * B] = a.f_vx; o[5 * B] = a.f_vy; o[6 * B] = a.f_agx; o[7 * B] = a.f_agy; o[8 * B] = a.f_ax; o[9 * B] = a.f_ay;
  o[10 * B] = a.wall; o[11 * B] = a.reached; o[12 * B] = a.stalled; o[13 * B] = a.trials;
}

template <bool kBox, bool kFull, bool kInject>
__global__ void __launch_bounds__(kThreads)
    planning_autoreset_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                              const float* __restrict__ noise, float* __restrict__ out, int64_t B,
                              const PlanningLaunch L, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  PlanningState st;
  load_planning_state(st_in, B, e, st);
  const float ux = act[e], uy = act[B + e];
  PlanningAux aux;
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    planning_autoreset_step<kBox, kFull>(L, n, st, ux, uy, aux);
  } else {
    PhiloxNoise n(seed, e);
    planning_autoreset_step<kBox, kFull>(L, n, st, ux, uy, aux);
  }
  store_planning_state(out, B, e, st);
  store_planning_aux(out, B, e, aux);
}

template <bool kBox, bool kFull, bool kInject>
struct AutoresetBody {
  static void launch(const float* st, const float* act, const float* noise, float* out, int64_t B,
                     const PlanningLaunch& L, Seed seed, cudaStream_t s) {
    planning_autoreset_kernel<kBox, kFull, kInject><<<num_blocks(B), kThreads, 0, s>>>(st, act, noise, out, B, L, seed);
  }
};

}  // namespace gprt

// st: [9, B] state planes; act: [2, B]; noise: [(2 + 2p) * num_cycles + 8 +
// 4 * cand_k, B] uniforms or null for Philox; out: [23, B].
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh).
extern "C" int gprt_planning_autoreset(const float* st, const float* act, const float* noise, float* out, int64_t B,
                                       const void* consts, const float* table, int n_cells, int box, int full,
                                       int jerk, int num_cycles, int cand_k, uint64_t seed_value,
                                       const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, cand_k);
  dispatch_planning<AutoresetBody>(box != 0, full != 0, noise != nullptr, st, act, noise, out, B, L, seed,
                                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
