// Kernel E: one single-mover planning env step of num_cycles control cycles.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py _step_kernel,
// reached from make_fused_planning_cycles.
//
// Bound on an H100: arithmetic per env, not bytes.  A cycle is ~40 flops of
// clamp chain and integration, one Box-Muller pair for the velocity reading
// and one (circle) or three (box, plus a quaternion normalisation) for the
// wall check, and the wall rule: ~20 comparisons on a full layout, a walk
// over the cell table on a holed one.  The env reads 8 planes and writes 7
// (60 B per step).  Design: one thread per env, the cycle loop in the
// thread, state in registers; the layout's rule is a template parameter so
// the full-layout main path carries no table walk.

#include "planning.cuh"

namespace gprt {

template <bool kBox, bool kFull, bool kInject>
__global__ void __launch_bounds__(kThreads)
    planning_cycles_kernel(const float* __restrict__ in, const float* __restrict__ noise, float* __restrict__ out,
                           int64_t B, const PlanningLaunch L, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  Mover m;
  m.px = in[0 * B + e]; m.py = in[1 * B + e]; m.vx = in[2 * B + e]; m.vy = in[3 * B + e];
  m.ax = in[4 * B + e]; m.ay = in[5 * B + e];
  const float ux = in[6 * B + e], uy = in[7 * B + e];
  float wall;
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    wall = planning_cycles<kBox, kFull>(L, n, m, ux, uy);
  } else {
    PhiloxNoise n(seed, e);
    wall = planning_cycles<kBox, kFull>(L, n, m, ux, uy);
  }
  out[0 * B + e] = m.px; out[1 * B + e] = m.py; out[2 * B + e] = m.vx; out[3 * B + e] = m.vy;
  out[4 * B + e] = m.ax; out[5 * B + e] = m.ay; out[6 * B + e] = wall;
}

template <bool kBox, bool kFull, bool kInject>
struct CyclesBody {
  static void launch(const float* in, const float* noise, float* out, int64_t B, const PlanningLaunch& L,
                     Seed seed, cudaStream_t s) {
    planning_cycles_kernel<kBox, kFull, kInject><<<num_blocks(B), kThreads, 0, s>>>(in, noise, out, B, L, seed);
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
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh).
extern "C" int gprt_planning_cycles(const float* in, const float* noise, float* out, int64_t B, const void* consts,
                                    const float* table, int n_cells, int box, int full, int jerk, int num_cycles,
                                    uint64_t seed_value, const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, 0);
  dispatch_planning<CyclesBody>(box != 0, full != 0, noise != nullptr, in, noise, out, B, L, seed,
                                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
