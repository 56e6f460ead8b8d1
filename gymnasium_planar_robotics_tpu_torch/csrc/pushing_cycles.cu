// Kernel B: one pushing env step of num_cycles control cycles.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py _pushing_kernel
// (body _make_pushing_cycles), reached from make_fused_pushing_cycles, for
// the circle and the box collision shape (kBox).
//
// Bound on an H100: arithmetic per env, not bytes.  Each cycle is ~150
// flops with 6 transcendentals (Box-Muller x2, cos/sin of the yaw) and ~10
// divisions; the box adds two Box-Muller pairs, the quaternion's
// normalisation and four vertex transforms a cycle.  The env reads 18 and
// writes 17 planes once per step (140 B).  At the main path's 4096 envs a
// thread-per-env launch holds one warp on a quarter of the card's
// schedulers, so it takes as long as one env's dependent chain of 40
// cycles, part of which (Philox, Box-Muller, the box's rotation) reads no
// state.  Design (pushing.cuh, split_body, a step without its step stage):
// kernel C's warp-specialised blocks of 32 envs, one consumer warp that runs
// the cycles from registers and one producer warp that computes each
// cycle's velocity pair and wall pose ahead of it through a ring in shared
// memory; above pushing's WIDE_BATCH for kernel B, where the card's issue
// rate binds, the wrapper launches blocks whose every warp draws its own
// (the thread-per-env arithmetic).  Loads and stores are coalesced over the
// env dimension.

#include "pushing.cuh"

namespace gprt {

// the 16 physics planes and the action in, the 16 physics planes and the
// wall flag out
struct CyclesIo {
  const float* in;
  float* out;
  int64_t B;
  __device__ void load(int64_t e, StepState& st) const { load_phys(in, B, e, st.p); }
  __device__ void step(int64_t e, int, const StepState& st, const StepAux& aux, float, float) {
    store_phys(out, B, e, st.p);
    out[16 * B + e] = aux.wall;
  }
  __device__ void finish(int64_t, const StepState&) {}
};

template <bool kJerk, bool kBox, bool kInject>
__global__ void __launch_bounds__(kSplitMaxThreads)
    pushing_cycles_kernel(const float* __restrict__ in, const float* __restrict__ noise, float* __restrict__ out,
                          int64_t B, const Consts c, int num_cycles, Seed seed, bool producer) {
  CyclesIo io{in, out, B};
  const float* act = in + 16 * B;
  if constexpr (kInject) {
    split_body<kJerk, kBox, Steps::kCycles>(c, InjectedSource{noise, B}, act, B, 1, num_cycles, 0, producer, io);
  } else {
    split_body<kJerk, kBox, Steps::kCycles>(c, PhiloxSource{seed.get()}, act, B, 1, num_cycles, 0, producer, io);
  }
}

template <bool kJerk, bool kBox>
void launch_cycles(const float* in, const float* noise, float* out, int64_t B, const Consts& c, int num_cycles,
                   Seed seed, bool producer, cudaStream_t s) {
  const auto kernel = noise != nullptr ? pushing_cycles_kernel<kJerk, kBox, true>
                                       : pushing_cycles_kernel<kJerk, kBox, false>;
  kernel<<<split_blocks(producer, B), split_threads(producer), split_shared_bytes(producer), s>>>(
      in, noise, out, B, c, num_cycles, seed, producer);
}

}  // namespace gprt

#define GPRT_NAME_STRING(name) #name ","
// Comma-terminated field names of gprt::Consts, in order (checked by the
// Python loader against its own list).
extern "C" const char* gprt_const_names() { return GPRT_CONST_FIELDS(GPRT_NAME_STRING); }
#undef GPRT_NAME_STRING

// in: [18, B] (16 physics planes + action x/y); noise: [(2 + 2p)*num_cycles,
// B] uniforms (p = 1 circle, 3 box) or null for Philox; out: [17, B] (16
// physics planes + wall).  consts: host pointer to a gprt::Consts.  The
// Philox seed is *seed_dev when seed_dev (device memory) is not null, else
// seed_value.  producer: 1 for blocks with the producer warp, 0 for blocks
// whose every warp draws its own values.
extern "C" int gprt_pushing_cycles(const float* in, const float* noise, float* out, int64_t B, const void* consts,
                                   int num_cycles, int learn_jerk, int box, uint64_t seed_value,
                                   const int64_t* seed_dev, int producer, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  if (producer != 0 && producer != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (learn_jerk) {
    (box ? launch_cycles<true, true> : launch_cycles<true, false>)(in, noise, out, B, c, num_cycles, seed, producer,
                                                                   s);
  } else {
    (box ? launch_cycles<false, true> : launch_cycles<false, false>)(in, noise, out, B, c, num_cycles, seed,
                                                                     producer, s);
  }
  return static_cast<int>(cudaGetLastError());
}
