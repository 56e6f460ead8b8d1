// Kernel A: the noise probe.
//
// Replaces: gymnasium_planar_robotics_tpu/ops/pallas_step.py make_noise_probe
// (its inner `kernel`): 2*draws standard normals per env by Box-Muller, from
// pre-drawn uniforms or from the generator inside the kernel.
//
// Bound on an H100: it writes 4 bytes per normal and, in the Philox mode,
// reads nothing; per normal pair it computes one logf, one sqrtf and the
// sine and cosine of one angle, at full precision, plus 10 Philox rounds per
// 4 uniforms, which set its time above the bytes' bound at many pairs.
//
// Design: the pairs of an env are independent, so they are spread over
// threads instead of a loop on one thread per env.  A unit of work is one
// Philox block (draws 4k..4k+3: normal pairs 2k and 2k + 1, the block
// computed once for both) in the Philox mode, one pair (its two uniforms)
// in the injected mode.  The grid is 2-D: env blockIdx.x * blockDim.x +
// threadIdx.x, so a warp's lanes hold neighbouring envs and every load and
// store of the [2*draws, B] planes is coalesced; units blockIdx.y,
// blockIdx.y + gridDim.y, ...  The wrapper (`noise.probe_grid`) caps
// gridDim.y at `noise.A_WAVES` waves of the card's resident threads, so a
// launch with many pairs keeps each thread on a few units instead of
// launching more blocks than the card holds.  The stream does not change:
// draw d of env e is word d % 4 of Philox at counter (d / 4, e, 0, 0).  One
// sincosf per pair in place of cosf and sinf (full precision: no
// --use_fast_math).  At many pairs the time is the instructions' issue: a
// Philox block and its two pairs take ~250 instructions on the fast path.
//
// The eager functions of the port (reset, observation noise, the noisy
// collision checks) draw their normals through this kernel on the card, in
// its Philox mode.

#include "common.cuh"

namespace gprt {

// Box-Muller (box_muller, common.cuh) of uniforms u, u2 into rows `row` and
// `row + 1` of an env's column `col` (stride B), with one sincosf
__device__ __forceinline__ void box_muller_store(float u, float u2, float* col, uint32_t row, uint32_t B) {
  const float r = sqrtf(-2.0f * logf(1.0f - u));
  float s, c;
  sincosf(kTwoPi * u2, &s, &c);
  col[static_cast<size_t>(row) * B] = r * c;
  col[static_cast<size_t>(row + 1) * B] = r * s;
}

template <bool kInject>
__global__ void noise_probe_kernel(const float* __restrict__ noise, float* __restrict__ out, uint32_t B,
                                   uint32_t pairs, Seed seed) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float* col = out + e;
  if constexpr (kInject) {
    const float* in = noise + e;
    for (uint32_t p = blockIdx.y; p < pairs; p += gridDim.y) {
      box_muller_store(__ldg(in + static_cast<size_t>(2 * p) * B), __ldg(in + static_cast<size_t>(2 * p + 1) * B),
                       col, 2 * p, B);
    }
  } else {
    const uint64_t s = seed.get();
    const uint2 key = make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32));
    const uint32_t units = (pairs + 1) / 2;
    for (uint32_t k = blockIdx.y; k < units; k += gridDim.y) {
      const uint4 w = philox4x32_10(make_uint4(k, e, 0u, 0u), key);
      box_muller_store(bits_to_uniform(w.x), bits_to_uniform(w.y), col, 4 * k, B);
      if (2 * k + 1 < pairs) box_muller_store(bits_to_uniform(w.z), bits_to_uniform(w.w), col, 4 * k + 2, B);
    }
  }
}

// An empty kernel on kernel A's grid.  It replaces no TPU kernel: timed
// beside A, it is the floor of a launch of A's shape on the card.
__global__ void empty_kernel() {}

inline bool grid_ok(unsigned int gx, unsigned int gy, int threads) {
  return threads > 0 && threads <= 1024 && gx > 0 && gy > 0 && gy <= 65535u;
}

}  // namespace gprt

// noise: [2*draws, B] uniforms, or null for the in-kernel Philox stream.
// out: [2*draws, B].  seed_value, seed_dev: the Philox seed (gprt::Seed,
// common.cuh).  grid_x, grid_y, threads: the launch shape
// (`noise.probe_grid`: grid_x blocks of `threads` cover the B envs, once).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// grid that does not cover the envs once, or B past 32 bits).
extern "C" int gprt_noise_probe(const float* noise, float* out, int64_t B, int draws, uint64_t seed_value,
                                const int64_t* seed_dev, unsigned int grid_x, unsigned int grid_y, int threads,
                                void* stream) {
  using namespace gprt;
  const Seed seed{seed_value, seed_dev};
  if (B <= 0 || draws <= 0) return 0;
  if (!grid_ok(grid_x, grid_y, threads) || B > 0xFFFFFFFFll || static_cast<int64_t>(grid_x) * threads < B ||
      static_cast<int64_t>(grid_x - 1) * threads >= B) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  const uint32_t b = static_cast<uint32_t>(B), pairs = static_cast<uint32_t>(draws);
  if (noise != nullptr) {
    noise_probe_kernel<true><<<grid, threads, 0, s>>>(noise, out, b, pairs, seed);
  } else {
    noise_probe_kernel<false><<<grid, threads, 0, s>>>(noise, out, b, pairs, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on a grid of kernel A (`noise.probe_grid`).  Returns
// cudaGetLastError() after the launch.
extern "C" int gprt_empty_launch(unsigned int grid_x, unsigned int grid_y, int threads, void* stream) {
  using namespace gprt;
  if (!grid_ok(grid_x, grid_y, threads)) return cudaErrorInvalidValue;
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
