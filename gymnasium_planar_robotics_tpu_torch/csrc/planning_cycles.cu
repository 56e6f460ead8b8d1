// Kernel E: one single-mover planning env step of num_cycles control cycles.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py _step_kernel,
// reached from make_fused_planning_cycles.
//
// Bound on an H100: arithmetic and latency per env, not bytes.  A cycle is
// ~40 flops of clamp chain and integration, one Box-Muller pair for the
// velocity reading and one (circle) or three (box, plus a quaternion
// normalisation) for the wall check, and the wall rule: ~20 comparisons on
// a full layout, a walk over the cell table on a holed one.  The env reads 8
// planes and writes 7 (60 B per step).  At the main path's 4096 envs a
// thread-per-env launch holds one warp on a quarter of the card's
// schedulers, so it takes as long as one env's dependent chain, most of
// which (Philox, Box-Muller, the box's rotation) reads no state.  Design
// (planning.cuh, planning_body, a step without its step stage): kernel F's
// warp-specialised blocks of 32 envs, one consumer warp that runs the
// cycles from registers and kPlanningProducers producer warps that compute
// each cycle's velocity pair and wall pose ahead of it through a ring in
// shared memory; above planning's WIDE_BATCH for kernel E, where the card's
// issue rate binds, the wrapper launches thread-per-env blocks.  The
// layout's rule is a template parameter, so the full-layout main path
// carries no table walk.

#include "planning.cuh"

namespace gprt {

// the 6 mover planes and the action in, the 6 mover planes and the wall
// flag out
struct CyclesIo {
  const float* in;
  float* out;
  int64_t B;
  __device__ void load(int64_t e, PlanningState& st) const {
    st.m.px = in[0 * B + e]; st.m.py = in[1 * B + e]; st.m.vx = in[2 * B + e]; st.m.vy = in[3 * B + e];
    st.m.ax = in[4 * B + e]; st.m.ay = in[5 * B + e];
  }
  __device__ void step(int64_t e, int, const PlanningState& st, const PlanningAux& a) {
    out[0 * B + e] = st.m.px; out[1 * B + e] = st.m.py; out[2 * B + e] = st.m.vx; out[3 * B + e] = st.m.vy;
    out[4 * B + e] = st.m.ax; out[5 * B + e] = st.m.ay; out[6 * B + e] = a.wall;
  }
  __device__ void finish(int64_t, const PlanningState&) {}
};

template <bool kBox, bool kFull, bool kInject, bool kProducer>
__global__ void __launch_bounds__(kPlanningMaxThreads)
    planning_cycles_kernel(const float* __restrict__ in, const float* __restrict__ noise, float* __restrict__ out,
                           int64_t B, const PlanningLaunch L, Seed seed) {
  CyclesIo io{in, out, B};
  const float* act = in + 6 * B;
  if constexpr (kInject) {
    planning_body<kBox, kFull, kProducer, Steps::kCycles>(L, InjectedSource{noise, B}, act, B, 1, io);
  } else {
    planning_body<kBox, kFull, kProducer, Steps::kCycles>(L, PhiloxSource{seed.get()}, act, B, 1, io);
  }
}

template <bool kBox, bool kFull, bool kInject>
struct CyclesBody {
  static void launch(const float* in, const float* noise, float* out, int64_t B, const PlanningLaunch& L,
                     Seed seed, bool producer, cudaStream_t s) {
    const auto kernel = producer ? planning_cycles_kernel<kBox, kFull, kInject, true>
                                 : planning_cycles_kernel<kBox, kFull, kInject, false>;
    launch_planning(kernel, producer, B, s, in, noise, out, B, L, seed);
  }
};

}  // namespace gprt

#define GPRT_NAME_STRING(name) #name ","
// Comma-terminated field names of gprt::PlanningConsts, in order (checked by
// the Python loader against its own list).
extern "C" const char* gprt_planning_const_names() { return GPRT_PLANNING_FIELDS(GPRT_NAME_STRING); }
#undef GPRT_NAME_STRING

// in: [8, B] (pos x/y, vel x/y, act x/y, action x/y); noise: [(2 + 2p) *
// num_cycles, B] uniforms or null for Philox; out: [7, B] (6 mover planes +
// wall).  consts: host pointer to a gprt::PlanningConsts; table: device
// wall table of n_cells cells (holed layouts; null when full != 0).
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh); producer:
// 1 for blocks with the producer (planning.cuh, kPlanningProducers warps), 0
// for thread-per-env blocks.
extern "C" int gprt_planning_cycles(const float* in, const float* noise, float* out, int64_t B, const void* consts,
                                    const float* table, int n_cells, int box, int full, int jerk, int num_cycles,
                                    uint64_t seed_value, const int64_t* seed_dev, int producer, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  if (producer != 0 && producer != 1) return static_cast<int>(cudaErrorInvalidValue);
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, 0);
  dispatch_planning<CyclesBody>(box != 0, full != 0, noise != nullptr, in, noise, out, B, L, seed, producer != 0,
                                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
