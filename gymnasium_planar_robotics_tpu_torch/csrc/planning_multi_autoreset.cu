// Kernel H: one M-mover planning autoreset env step, the C interface.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_multi_autoreset_kernel, reached from
// make_fused_planning_multi_autoreset_cycles.  The device code, its bound
// and its design (lane groups: G lanes an env, L mover slots a lane; from 88
// movers one warp an env with the movers in shared memory) are in
// planning_multi.cuh.  Eight instantiations: L in {1, 2, 4} x the collision
// shape, L = 4 only at 65-87 movers, and the many-mover variant x the shape
// (M, G, the layout rule and the noise mode are run-time values).

#include "planning_multi.cuh"

#define GPRT_MULTI_NAME_STRING(name, rule) #name ":" #rule ","
// Comma-terminated "name:length rule" of the constants vector, in order
// (checked by the Python loader against its own list).
extern "C" const char* gprt_multi_const_names() { return GPRT_MULTI_FIELDS(GPRT_MULTI_NAME_STRING); }
#undef GPRT_MULTI_NAME_STRING

// st: [8M + 1, B] state planes; act: [2M, B]; noise: [(2 + 4p) * M *
// num_cycles + 8M + 4M * cand_k, B] uniforms or null for Philox; out:
// [18M + 6, B]; consts: the planning constants (host, by value);
// multi_consts: the constants vector for m movers in device memory;
// sizes64: [3, m] float64 per-mover sizes in device memory (read by the
// many-mover variant only).  lanes (G, a power of two up to 32) and slots (L
// in {1, 2, 4}) with G * L >= m <= kMaxSlotMovers lay an env over a group of
// lanes; slots 0 with lanes 32 runs the many-mover variant (any m up to
// kMaxMovers).  Returns cudaErrorInvalidValue for m outside 2 ... kMaxMovers
// or a layout outside those.  seed_value, seed_dev: the Philox seed
// (gprt::Seed, common.cuh).
extern "C" int gprt_planning_multi_autoreset(const float* st, const float* act, const float* noise, float* out,
                                             int64_t B, const void* consts, const float* multi_consts,
                                             const double* sizes64, const float* table, int n_cells, int m,
                                             int lanes, int slots, int box, int full, int jerk, int num_cycles,
                                             int cand_k, uint64_t seed_value, const int64_t* seed_dev,
                                             void* stream) {
  using namespace gprt;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool many = slots == 0 && lanes == 32;
  if (m < 2 || m > kMaxMovers || !lanes_ok || !(many || (m <= kMaxSlotMovers && lanes * slots >= m))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return 0;
  const Seed seed{seed_value, seed_dev};
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, cand_k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fl = full != 0;
  if (many) {
    return static_cast<int>((box != 0 ? launch_planning_multi_many<true> : launch_planning_multi_many<false>)(
        st, act, noise, out, B, L, multi_consts, sizes64, m, fl, seed, s));
  }
  cudaError_t err;
#define GPRT_MULTI_CASE(LL)                                                                                      \
  case LL:                                                                                                       \
    err = (box != 0 ? launch_planning_multi<LL, true> : launch_planning_multi<LL, false>)(st, act, noise, out, B, \
                                                                                          L, multi_consts, m,    \
                                                                                          lanes, fl, seed, s);   \
    break;
  switch (slots) {
    GPRT_MULTI_CASE(1) GPRT_MULTI_CASE(2) GPRT_MULTI_CASE(4)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPRT_MULTI_CASE
  return static_cast<int>(err);
}
