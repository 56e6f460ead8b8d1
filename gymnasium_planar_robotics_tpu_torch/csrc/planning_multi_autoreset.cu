// Kernel H: one M-mover planning autoreset env step, the C interface.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _planning_multi_autoreset_kernel, reached from
// make_fused_planning_multi_autoreset_cycles.  The device code, its bound
// and its design are in planning_multi.cuh; the instantiations for
// M = 2 ... kMaxMovers and each collision shape in
// planning_multi_m<M>_<shape>.cu.

#include "planning_multi.cuh"

namespace gprt {
extern template GPRT_MULTI_LAUNCH_SIGNATURE(2, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(2, true);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(3, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(3, true);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(4, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(4, true);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(5, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(5, true);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(6, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(6, true);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(7, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(7, true);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(8, false);
extern template GPRT_MULTI_LAUNCH_SIGNATURE(8, true);
}  // namespace gprt

#define GPRT_MULTI_NAME_STRING(name, n) #name ":" #n ","
// Comma-terminated "name:length" of gprt::MultiConsts, in order (checked by
// the Python loader against its own list).
extern "C" const char* gprt_multi_const_names() { return GPRT_MULTI_FIELDS(GPRT_MULTI_NAME_STRING); }
#undef GPRT_MULTI_NAME_STRING

// st: [8M + 1, B] state planes; act: [2M, B]; noise: [(2 + 4p) * M *
// num_cycles + 8M + 4M * cand_k, B] uniforms or null for Philox; out:
// [18M + 6, B].  Returns cudaErrorInvalidValue for M outside 2 ... 8.
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh).
extern "C" int gprt_planning_multi_autoreset(const float* st, const float* act, const float* noise, float* out,
                                             int64_t B, const void* consts, const void* multi_consts,
                                             const float* table, int n_cells, int m, int box, int full, int jerk,
                                             int num_cycles, int cand_k, uint64_t seed_value,
                                             const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  const PlanningLaunch L = make_planning_launch(consts, table, n_cells, jerk, num_cycles, cand_k);
  const MultiConsts mc = *static_cast<const MultiConsts*>(multi_consts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fl = full != 0, inj = noise != nullptr;
#define GPRT_MULTI_CASE(M)                                                                 \
  case M:                                                                                  \
    (box != 0 ? launch_planning_multi<M, true> : launch_planning_multi<M, false>)(fl, inj, st, act, noise, out, B, \
                                                                                   L, mc, seed, s);               \
    break;
  switch (m) {
    GPRT_MULTI_CASE(2) GPRT_MULTI_CASE(3) GPRT_MULTI_CASE(4) GPRT_MULTI_CASE(5) GPRT_MULTI_CASE(6)
    GPRT_MULTI_CASE(7) GPRT_MULTI_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPRT_MULTI_CASE
  return static_cast<int>(cudaGetLastError());
}
