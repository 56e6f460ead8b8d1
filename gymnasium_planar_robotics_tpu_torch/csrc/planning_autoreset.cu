// Kernel F: one single-mover planning autoreset env step.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_autoreset_kernel (body _planning_autoreset_step), reached from
// make_fused_planning_autoreset_cycles.
//
// Bound on an H100: arithmetic and latency per env.  Kernel E's cycles, four
// normal pairs for the observations, and two first-accepted samplers of up
// to cand_k wall-checked candidates each.  Bytes are small: 11 planes in and
// 23 out per env (136 B, 0.56 MB at 4096 envs, ~0.17 us of HBM time).  At
// the main path's 4096 envs a thread-per-env launch holds one warp on a
// quarter of the card's schedulers, so it takes as long as one env's
// dependent chain, most of which (Philox, Box-Muller, the samplers) reads no
// state.  Design (planning.cuh, planning_body): warp-specialised blocks of
// 32 envs, one consumer warp that runs the physics from registers and
// producer warps that compute the noise and the restart ahead of it through
// a ring in shared memory; above planning's WIDE_BATCH, where the card's
// issue rate binds, the wrapper launches thread-per-env blocks instead,
// whose samplers run only for envs that are done.  Output order is the Pallas raw_planes contract: 9
// state planes, post-reset obs (vel x/y, achieved x/y), pre-reset obs (vel
// x/y, achieved x/y, act x/y), wall, reached, stalled, trials.

#include "planning.cuh"

namespace gprt {

// the 9 state planes in, the 23 output planes out of a one-step launch
struct AutoresetOut {
  const float* st_in;
  float* out;
  int64_t B;
  __device__ void load(int64_t e, PlanningState& st) const { load_planning_state(st_in, B, e, st); }
  __device__ void step(int64_t e, int, const PlanningState& st, const PlanningAux& a) {
    store_planning_state(out, B, e, st);
    float* o = out + 9 * B + e;
    o[0 * B] = a.s_vx; o[1 * B] = a.s_vy; o[2 * B] = a.s_agx; o[3 * B] = a.s_agy;
    o[4 * B] = a.f_vx; o[5 * B] = a.f_vy; o[6 * B] = a.f_agx; o[7 * B] = a.f_agy; o[8 * B] = a.f_ax; o[9 * B] = a.f_ay;
    o[10 * B] = a.wall; o[11 * B] = a.reached; o[12 * B] = a.stalled; o[13 * B] = a.trials;
  }
  __device__ void finish(int64_t, const PlanningState&) {}
};

template <bool kBox, bool kFull, bool kInject, bool kProducer>
__global__ void __launch_bounds__(kPlanningMaxThreads)
    planning_autoreset_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                              const float* __restrict__ noise, float* __restrict__ out, int64_t B,
                              const PlanningLaunch L, Seed seed) {
  AutoresetOut o{st_in, out, B};
  if constexpr (kInject) {
    planning_body<kBox, kFull, kProducer, Steps::kAutoreset>(L, InjectedSource{noise, B}, act, B, 1, o);
  } else {
    planning_body<kBox, kFull, kProducer, Steps::kAutoreset>(L, PhiloxSource{seed.get()}, act, B, 1, o);
  }
}

template <bool kBox, bool kFull, bool kInject>
struct AutoresetBody {
  static void launch(const float* st, const float* act, const float* noise, float* out, int64_t B,
                     const PlanningLaunch& L, Seed seed, bool producer, cudaStream_t s) {
    const auto kernel = producer ? planning_autoreset_kernel<kBox, kFull, kInject, true>
                                 : planning_autoreset_kernel<kBox, kFull, kInject, false>;
    launch_planning(kernel, producer, B, s, st, act, noise, out, B, L, seed);
  }
};

}  // namespace gprt

// st: [9, B] state planes; act: [2, B]; noise: [(2 + 2p) * num_cycles + 8 +
// 4 * cand_k, B] uniforms or null for Philox; out: [23, B].
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh); producer:
// 1 for blocks with the producer (planning.cuh, kPlanningProducers warps), 0
// for thread-per-env blocks.
extern "C" int gprt_planning_autoreset(const float* st, const float* act, const float* noise, float* out, int64_t B,
                                       const void* consts, const float* table, int n_cells, int box, int full,
                                       int jerk, int num_cycles, int cand_k, uint64_t seed_value,
                                       const int64_t* seed_dev, int producer, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  if (producer != 0 && producer != 1) return static_cast<int>(cudaErrorInvalidValue);
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, cand_k);
  dispatch_planning<AutoresetBody>(box != 0, full != 0, noise != nullptr, st, act, noise, out, B, L, seed,
                                   producer != 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
