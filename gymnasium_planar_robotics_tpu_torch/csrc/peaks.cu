// Kernel I: the roofline's peak probes.
//
// Replaces: bench.py _microbench_peaks, its two Pallas kernels fma_kern
// (a dependent chain acc = acc * 1.0000001 + x per element) and transc_kern
// (acc = cos(sqrt(-2 log(acc * 0.49 + 0.5))) * 0.5 + 0.5, the Box-Muller
// mix of log, sqrt and cos), launched through pl.pallas_call.  Each
// computes, element by element, K steps of its chain from acc = x, and
// writes the last acc.
//
// Bound on an H100: operations, by design.  fma: one FFMA per element and
// step (2 flops), against the 128 FP32 lanes of each of the 132 SMs; the
// bytes (one read and one write per element) are nothing beside K steps.
// transc: the FP32 and MUFU instructions of IEEE logf, sqrtf and cosf (the
// functions the kernels' Box-Muller calls; no fast-math intrinsics).
//
// Design: the TPU shape ([512, 128] with one chain per element) is not
// carried over.  One dependent chain per thread leaves the FMA pipe idle
// for its latency, so each thread runs kChains independent chains (the
// elements e, e + n/kChains, ...), interleaved in one loop, and the caller
// sizes the grid to several blocks per SM.  The affine steps of transc
// round each operation, as the plain version does.

#include "common.cuh"

namespace gprt {

constexpr int kPeakThreads = 256;
constexpr int kFmaChains = 8;
constexpr int kTranscChains = 4;

__global__ void __launch_bounds__(kPeakThreads) peak_fma_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                                int64_t n_threads, int k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  float xs[kFmaChains], acc[kFmaChains];
#pragma unroll
  for (int c = 0; c < kFmaChains; ++c) acc[c] = xs[c] = x[c * n_threads + t];
  // unrolled so that the loop's own instructions take few issue slots
#pragma unroll 16
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int c = 0; c < kFmaChains; ++c) acc[c] = fmaf(acc[c], 1.0000001f, xs[c]);
  }
#pragma unroll
  for (int c = 0; c < kFmaChains; ++c) out[c * n_threads + t] = acc[c];
}

__global__ void __launch_bounds__(kPeakThreads) peak_transc_kernel(const float* __restrict__ x,
                                                                   float* __restrict__ out, int64_t n_threads, int k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  float acc[kTranscChains];
#pragma unroll
  for (int c = 0; c < kTranscChains; ++c) acc[c] = x[c * n_threads + t];
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int c = 0; c < kTranscChains; ++c) {
      const float u = add(mul(acc[c], 0.49f), 0.5f);
      acc[c] = add(mul(cosf(sqrtf(mul(-2.0f, logf(u)))), 0.5f), 0.5f);
    }
  }
#pragma unroll
  for (int c = 0; c < kTranscChains; ++c) out[c * n_threads + t] = acc[c];
}

}  // namespace gprt

// x, out: [n] f32 with n a multiple of the probe's chains per thread
// (gprt_peak_chains); element c * (n / chains) + t is chain c of thread t.
// Returns cudaGetLastError() after the launch.
extern "C" int gprt_peak_chains(int transc) { return transc ? gprt::kTranscChains : gprt::kFmaChains; }

extern "C" int gprt_peak(const float* x, float* out, int64_t n, int k, int transc, void* stream) {
  using namespace gprt;
  const int chains = transc ? kTranscChains : kFmaChains;
  const int64_t n_threads = n / chains;
  if (n_threads <= 0 || k < 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = static_cast<unsigned int>((n_threads + kPeakThreads - 1) / kPeakThreads);
  if (transc) {
    peak_transc_kernel<<<blocks, kPeakThreads, 0, s>>>(x, out, n_threads, k);
  } else {
    peak_fma_kernel<<<blocks, kPeakThreads, 0, s>>>(x, out, n_threads, k);
  }
  return static_cast<int>(cudaGetLastError());
}
