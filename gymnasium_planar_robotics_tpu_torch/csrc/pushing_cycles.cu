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
// writes 17 planes once per step (140 B).  Registers hold the whole state.
// Design: one thread per env and the cycle loop inside the thread, so state
// never leaves registers between cycles; loads and stores are coalesced over
// the env dimension.  At 4096 envs this is 32 blocks of 128 on 132 SMs:
// occupancy, not the SM's arithmetic, limits small batches.

#include "pushing.cuh"

namespace gprt {

template <bool kJerk, bool kBox, bool kInject>
__global__ void __launch_bounds__(kThreads)
    pushing_cycles_kernel(const float* __restrict__ in, const float* __restrict__ noise, float* __restrict__ out,
                          int64_t B, const Consts c, int num_cycles, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  Phys s;
  load_phys(in, B, e, s);
  const float ux = in[16 * B + e], uy = in[17 * B + e];
  float wall;
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    wall = run_cycles<kJerk, kBox>(c, n, num_cycles, s, ux, uy);
  } else {
    PhiloxNoise n(seed, e);
    wall = run_cycles<kJerk, kBox>(c, n, num_cycles, s, ux, uy);
  }
  store_phys(out, B, e, s);
  out[16 * B + e] = wall;
}

template <bool kJerk, bool kBox>
void launch_cycles(const float* in, const float* noise, float* out, int64_t B, const Consts& c, int num_cycles,
                   Seed seed, cudaStream_t s) {
  if (noise != nullptr) {
    pushing_cycles_kernel<kJerk, kBox, true><<<num_blocks(B), kThreads, 0, s>>>(in, noise, out, B, c, num_cycles,
                                                                                 seed);
  } else {
    pushing_cycles_kernel<kJerk, kBox, false><<<num_blocks(B), kThreads, 0, s>>>(in, noise, out, B, c, num_cycles,
                                                                                  seed);
  }
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
// seed_value.
extern "C" int gprt_pushing_cycles(const float* in, const float* noise, float* out, int64_t B, const void* consts,
                                   int num_cycles, int learn_jerk, int box, uint64_t seed_value,
                                   const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0) return 0;
  const Consts c = *static_cast<const Consts*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (learn_jerk) {
    (box ? launch_cycles<true, true> : launch_cycles<true, false>)(in, noise, out, B, c, num_cycles, seed, s);
  } else {
    (box ? launch_cycles<false, true> : launch_cycles<false, false>)(in, noise, out, B, c, num_cycles, seed, s);
  }
  return static_cast<int>(cudaGetLastError());
}
