// Kernel A: the noise probe.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py make_noise_probe
// (its inner `kernel`): 2*draws standard normals per env by Box-Muller, from
// pre-drawn uniforms or from the generator inside the kernel.
//
// Bound on an H100: transcendental throughput (logf, sqrtf, cosf, sinf per
// pair, plus 10 Philox rounds per 4 uniforms); it reads nothing in Philox
// mode and writes 4 bytes per normal.  Design: one thread per env, draws
// in a loop, stores coalesced across the env dimension; no shared memory.
//
// The eager functions of the port (reset, observation noise) draw their
// normals through this kernel on the card.

#include "common.cuh"

namespace gprt {

template <class Noise>
__device__ void probe_body(Noise& noise, float* out, int64_t B, int64_t e, int draws) {
  for (int d = 0; d < draws; ++d) {
    float a, b;
    normal_pair(noise, a, b);
    out[(2 * d) * B + e] = a;
    out[(2 * d + 1) * B + e] = b;
  }
}

template <bool kInject>
__global__ void __launch_bounds__(kThreads) noise_probe_kernel(const float* __restrict__ noise, float* __restrict__ out,
                                                               int64_t B, int draws, Seed seed) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B) return;
  if constexpr (kInject) {
    InjectedNoise n(noise, B, e);
    probe_body(n, out, B, e, draws);
  } else {
    PhiloxNoise n(seed, e);
    probe_body(n, out, B, e, draws);
  }
}

// An empty kernel on kernel A's grid (one thread per env, kThreads a
// block).  It replaces no TPU kernel: timed beside A, it is the floor of a
// launch of A's shape on the card.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace gprt

// noise: [2*draws, B] uniforms, or null for the in-kernel Philox stream.
// out: [2*draws, B].  Returns cudaGetLastError() after the launch.
// seed_value, seed_dev: the Philox seed (gprt::Seed, common.cuh).
extern "C" int gprt_noise_probe(const float* noise, float* out, int64_t B, int draws, uint64_t seed_value,
                                const int64_t* seed_dev, void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0 || draws <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise != nullptr) {
    noise_probe_kernel<true><<<num_blocks(B), kThreads, 0, s>>>(noise, out, B, draws, seed);
  } else {
    noise_probe_kernel<false><<<num_blocks(B), kThreads, 0, s>>>(noise, out, B, draws, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the grid kernel A takes for B envs.  Returns
// cudaGetLastError() after the launch.
extern "C" int gprt_empty_launch(int64_t B, void* stream) {
  using namespace gprt;
  if (B <= 0) return 0;
  empty_kernel<<<num_blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
