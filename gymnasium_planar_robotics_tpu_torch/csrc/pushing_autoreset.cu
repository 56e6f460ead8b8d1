// Kernel C: one pushing autoreset env step.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _pushing_autoreset_kernel (body _pushing_autoreset_step), reached from
// make_fused_pushing_autoreset_cycles.
//
// Bound on an H100: arithmetic per env (kernel B's cycles, plus 12 normals
// and 2*cand_k + 4 uniforms for the observations and the restart); bytes
// are small: 21 planes in and 36 out per env and step (~230 B, ~0.9 MB at
// 4096 envs).  Design: one thread per env; the restart's candidate loop
// runs in registers and keeps the first accepted candidate, so no
// candidate array is materialised.  Output order is the Pallas raw_planes
// contract: 19 state planes, post-reset obs (6), pre-reset obs (8), wall,
// stalled, trials.

#include "pushing.cuh"

namespace gprt {

__device__ __forceinline__ void store_aux(float* out, int64_t B, int64_t e, const StepAux& a) {
  float* o = out + 19 * B + e;
  o[0 * B] = a.s_mpx; o[1 * B] = a.s_mpy; o[2 * B] = a.s_mvx; o[3 * B] = a.s_mvy;
  o[4 * B] = a.s_agx; o[5 * B] = a.s_agy;
  o[6 * B] = a.f_mpx; o[7 * B] = a.f_mpy; o[8 * B] = a.f_mvx; o[9 * B] = a.f_mvy;
  o[10 * B] = a.f_agx; o[11 * B] = a.f_agy; o[12 * B] = a.f_qax; o[13 * B] = a.f_qay;
  o[14 * B] = a.wall; o[15 * B] = a.stalled; o[16 * B] = a.trials;
}

template <bool kJerk, bool kInject>
__global__ void __launch_bounds__(kThreads)
    pushing_autoreset_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                             const float* __restrict__ noise, float* __restrict__ out, int64_t B, const Consts c,
                             int num_cycles, int cand_k, uint64_t seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  StepState st;
  load_state(st_in, B, e, st);
  const float ux = act[e], uy = act[B + e];
  StepAux aux;
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    autoreset_step<kJerk>(c, n, num_cycles, cand_k, st, ux, uy, aux);
  } else {
    PhiloxNoise n(seed, e);
    autoreset_step<kJerk>(c, n, num_cycles, cand_k, st, ux, uy, aux);
  }
  store_state(out, B, e, st);
  store_aux(out, B, e, aux);
}

template <bool kJerk>
void launch_autoreset(const float* st, const float* act, const float* noise, float* out, int64_t B, const Consts& c,
                      int num_cycles, int cand_k, uint64_t seed, cudaStream_t s) {
  if (noise != nullptr) {
    pushing_autoreset_kernel<kJerk, true>
        <<<num_blocks(B), kThreads, 0, s>>>(st, act, noise, out, B, c, num_cycles, cand_k, seed);
  } else {
    pushing_autoreset_kernel<kJerk, false>
        <<<num_blocks(B), kThreads, 0, s>>>(st, act, noise, out, B, c, num_cycles, cand_k, seed);
  }
}

}  // namespace gprt

// st: [19, B] state planes; act: [2, B]; noise: [4*num_cycles + 16 +
// 2*cand_k, B] uniforms or null for Philox; out: [36, B].
extern "C" int gprt_pushing_autoreset(const float* st, const float* act, const float* noise, float* out, int64_t B,
                                      const void* consts, int num_cycles, int cand_k, int learn_jerk, uint64_t seed,
                                      void* stream) {
  using namespace gprt;
  if (B <= 0) return 0;
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (learn_jerk) {
    launch_autoreset<true>(st, act, noise, out, B, c, num_cycles, cand_k, seed, s);
  } else {
    launch_autoreset<false>(st, act, noise, out, B, c, num_cycles, cand_k, seed, s);
  }
  return static_cast<int>(cudaGetLastError());
}
