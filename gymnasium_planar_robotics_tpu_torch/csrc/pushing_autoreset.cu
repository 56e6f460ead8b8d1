// Kernel C: one pushing autoreset env step, optionally with the two policy
// feature blocks (C-feat).
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py
// _pushing_autoreset_kernel (body _pushing_autoreset_step), reached from
// make_fused_pushing_autoreset_cycles; the emit_features variant
// (pallas_step.py:1066-1078) feeds the reactive rollout.  Each comes in the
// circle and the box collision shape (kBox).
//
// Bound on an H100: arithmetic per env (kernel B's cycles, plus 12 normals
// and 2*cand_k + 4 uniforms for the observations and the restart); bytes
// are small: 21 planes in and 36 out per env and step (~230 B, ~0.9 MB at
// 4096 envs), 24 more out with the features.  At the main path's 4096 envs
// the card holds one warp per busy scheduler, so a launch takes as long as
// one env's dependent chain of 40 cycles.  Design (pushing.cuh, split_body):
// warp-specialised blocks of 32 envs, one consumer warp that runs that
// chain from registers and one producer warp that computes every
// state-independent value (the cycles' normals, the box's rotations, the
// observation normals, the restart with its candidates searched across
// lanes) ahead of it through a ring in shared memory; above 32,768 envs,
// where the card's issue rate binds, the wrapper launches blocks whose
// every warp draws its own.  Output order is the
// Pallas raw_planes contract: 19 state planes, post-reset obs (6),
// pre-reset obs (8), wall, stalled, trials.  The feature blocks are written
// from the same registers after the step, so emitting them changes neither
// the 36 planes nor the draws.

#include <cstdio>

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

// One [12, B] feature block at f (the training recipes' layout): mover pos
// and vel, achieved, goal, achieved - mover, goal - achieved.
__device__ __forceinline__ void store_features(float* f, int64_t B, float mpx, float mpy, float mvx, float mvy,
                                               float agx, float agy, float gx, float gy) {
  f[0 * B] = mpx; f[1 * B] = mpy; f[2 * B] = mvx; f[3 * B] = mvy;
  f[4 * B] = agx; f[5 * B] = agy; f[6 * B] = gx; f[7 * B] = gy;
  f[8 * B] = agx - mpx; f[9 * B] = agy - mpy; f[10 * B] = gx - agx; f[11 * B] = gy - agy;
}

// the 19 state planes in, the 36 output planes (and with kEmit the feature
// blocks) out of a one-step launch
template <bool kEmit>
struct AutoresetOut {
  const float* st_in;
  float* out;
  float* feat;
  int64_t B;
  __device__ void load(int64_t e, StepState& st) const { load_state(st_in, B, e, st); }
  __device__ void step(int64_t e, int, const StepState& st, const StepAux& aux, float g_old_x, float g_old_y) {
    store_state(out, B, e, st);
    store_aux(out, B, e, aux);
    if constexpr (kEmit) {
      // feat [2, 12, B]: block 0 the post-reset observation with the
      // (possibly new) goal, block 1 the pre-reset one with the old goal
      store_features(feat + e, B, aux.s_mpx, aux.s_mpy, aux.s_mvx, aux.s_mvy, aux.s_agx, aux.s_agy, st.gx, st.gy);
      store_features(feat + 12 * B + e, B, aux.f_mpx, aux.f_mpy, aux.f_mvx, aux.f_mvy, aux.f_agx, aux.f_agy, g_old_x,
                     g_old_y);
    }
  }
  __device__ void finish(int64_t, const StepState&) {}
};

template <bool kJerk, bool kBox, bool kInject, bool kEmit>
__global__ void __launch_bounds__(kSplitMaxThreads)
    pushing_autoreset_kernel(const float* __restrict__ st_in, const float* __restrict__ act,
                             const float* __restrict__ noise, float* __restrict__ out, float* __restrict__ feat,
                             int64_t B, const Consts c, int num_cycles, int cand_k, Seed seed, bool producer) {
  AutoresetOut<kEmit> o{st_in, out, feat, B};
  if constexpr (kInject) {
    split_body<kJerk, kBox, Steps::kAutoreset>(c, InjectedSource{noise, B}, act, B, 1, num_cycles, cand_k, producer,
                                               o);
  } else {
    split_body<kJerk, kBox, Steps::kAutoreset>(c, PhiloxSource{seed.get()}, act, B, 1, num_cycles, cand_k, producer,
                                               o);
  }
}

template <bool kJerk, bool kBox, bool kInject, bool kEmit>
void launch_split(const float* st, const float* act, const float* noise, float* out, float* feat, int64_t B,
                  const Consts& c, int num_cycles, int cand_k, Seed seed, bool producer, cudaStream_t s) {
  constexpr auto kernel = pushing_autoreset_kernel<kJerk, kBox, kInject, kEmit>;
  kernel<<<split_blocks(producer, B), split_threads(producer), split_shared_bytes(producer), s>>>(
      st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, producer);
}

template <bool kJerk, bool kBox, bool kEmit>
void launch_by_noise(const float* st, const float* act, const float* noise, float* out, float* feat, int64_t B,
                     const Consts& c, int num_cycles, int cand_k, Seed seed, bool producer, cudaStream_t s) {
  if (noise != nullptr) {
    launch_split<kJerk, kBox, true, kEmit>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, producer, s);
  } else {
    launch_split<kJerk, kBox, false, kEmit>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, producer, s);
  }
}

template <bool kJerk, bool kBox>
void launch_autoreset(const float* st, const float* act, const float* noise, float* out, float* feat, int64_t B,
                      const Consts& c, int num_cycles, int cand_k, Seed seed, bool producer, cudaStream_t s) {
  if (feat != nullptr) {
    launch_by_noise<kJerk, kBox, true>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, producer, s);
  } else {
    launch_by_noise<kJerk, kBox, false>(st, act, noise, out, feat, B, c, num_cycles, cand_k, seed, producer, s);
  }
}

}  // namespace gprt

// st: [19, B] state planes; act: [2, B]; noise: [(2 + 2p)*num_cycles + 16 +
// 2*cand_k, B] uniforms (p = 1 circle, 3 box) or null for Philox; out:
// [36, B]; feat: [2, 12, B] feature blocks, or null for none;
// producer: 1 for blocks with the producer warp, 0 for blocks whose every
// warp draws its own values.  The Philox seed is *seed_dev when seed_dev
// (device memory) is not null, else seed_value.
extern "C" int gprt_pushing_autoreset(const float* st, const float* act, const float* noise, float* out, float* feat,
                                      int64_t B, const void* consts, int num_cycles, int cand_k, int learn_jerk,
                                      int box, uint64_t seed_value, const int64_t* seed_dev, int producer,
                                      void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (producer != 0 && producer != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (learn_jerk) {
    (box ? launch_autoreset<true, true> : launch_autoreset<true, false>)(st, act, noise, out, feat, B, c,
                                                                         num_cycles, cand_k, seed, producer, s);
  } else {
    (box ? launch_autoreset<false, true> : launch_autoreset<false, false>)(st, act, noise, out, feat, B, c,
                                                                           num_cycles, cand_k, seed, producer, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The producer/consumer layout of kernels C and D, for reports:
// "ring_slots=..,stage_values=..,stage_cycles_circle=..,stage_cycles_box=..".
extern "C" const char* gprt_split_layout() {
  using namespace gprt;
  static char text[160];
  std::snprintf(text, sizeof text, "ring_slots=%d,stage_values=%d,stage_cycles_circle=%d,stage_cycles_box=%d",
                kRingSlots, kStageValues, stage_cycles<false>(), stage_cycles<true>());
  return text;
}
