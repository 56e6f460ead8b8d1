// Kernel P: the reactive policy step of models/ppo.ActorCritic in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the policy to XLA
// (models/ppo.sample_action_pm there is jnp ops).  The port ran it as torch
// ops: a cuBLAS product and a bias copy a layer, tanh, both heads and the
// sample's elementwise chain, some twenty launches a step, each [256, B]
// activation plane written to device memory and read back several times.
// This kernel computes what ops/kernels/policy.policy_mlp_plain computes:
// the tanh trunk, the mu and value heads, raw = mu + exp(log_std) * eps, its
// Gaussian log-probability and the action clamped to [-scale, scale].
//
// Bound on an H100: operations.  A step of the (12, (256, 256), 2) policy
// needs 2 x (12*256 + 256*256 + 256*2 + 256) = 138,752 f32 operations an env:
// 9.09 GFLOP at 65,536 envs, 0.136 ms at 67 TFLOP/s.  Its necessary bytes
// are 80 an env (12 features and 2 noise values in; action, raw, logp and
// value out), 5.2 MB or 1.6 us.  So the rate of the FP32 lanes bounds it.
//
// Design: a block takes a tile of N envs and carries it through every layer
// with its activations in shared memory and registers, never in device
// memory.  The activation tile [widest][N] is 64 KB at every width: N = 64
// envs up to width 256, 32 up to 512, 16 up to 1024.  Each layer is a
// register-tiled SIMT product on the CUDA cores (f32 FMAs, no TF32 and no
// tensor cores, as the policy's precision states): 256 threads, each an
// 8 x 8 tile of outputs (rows tm + R*i, columns in two float4 halves), read
// with 16-byte shared loads, 16 loads to 256 FMAs.  The weights are read in
// place from the module's parameters (nn.Linear's [out, in] rows) in chunks
// of KC inputs through a double-buffered cp.async ring, so the next chunk's
// copy runs under this chunk's FMAs (one barrier a chunk); every block reads
// the whole of W2 (256 KB), which stays in L2.  The epilogue adds the bias
// and takes tanhf in registers, writes the next layer's input tile over the
// last one, and after the last layer multiplies by the thread's rows of the
// heads and sums the 32 partials of an env column in a fixed order (no
// atomics).  Two blocks an SM (106 KB of shared memory and 128 registers a
// thread each at N = 64) overlap one's epilogue with the other's products.
// Every env's arithmetic depends only on the layer widths, never on the
// batch or the env's place in it.  tanhf and expf are the accurate library
// functions (no --use_fast_math).
//
// Where it stands (H100, 65,536 envs): 0.28 ms, 2.1x the bound.  The
// products' FMAs issue at about 63% of the lanes' rate even with the shared
// loads and the weight copies taken out, as cuBLAS's SIMT kernels do on this
// card; tanhf takes 13% of the time and the weight copies' waits 7%; one
// block an SM (more registers a thread) or longer chunks (fewer blocks) are
// slower.

#include "common.cuh"

namespace gprt {

constexpr int kPolicyThreads = 256;
constexpr int kPolicyMaxDepth = 8;
constexpr int kPolicyMaxActions = 7;       // the heads' partials (A + 1) x 2048 fill the activation tile
constexpr int kPolicyTileFloats = 16384;   // the activation tile: widest layer x env tile
constexpr float kHalfLog2Pi = 0.91893853320467274178f;

struct PolicyLayer {
  const float* w;  // [m, k], row-major (nn.Linear.weight)
  const float* b;  // [m]
  int k, m;
  int vec;         // rows copied 16 bytes at a time (k % 4 == 0, w 16-byte aligned)
};

struct PolicyArgs {
  const float* x;    // [f, batch]
  const float* eps;  // [a, batch]
  float* out;        // [2a + 2, batch]: action, raw, logp, value
  PolicyLayer layer[kPolicyMaxDepth];
  const float *w_mu, *b_mu, *w_v, *b_v, *log_std;
  int depth, a, f;
  float scale;
  int64_t batch;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The policy kernel's shape at env tile N.
template <int N>
struct PolicyShape {
  static constexpr int kWidest = kPolicyTileFloats / N;  // rows of the activation tile
  static constexpr int kRowGroups = kWidest / 8;         // threads along the rows (R)
  static constexpr int kColGroups = N / 8;               // threads along the envs
  static constexpr int kChunk = N / 4;                   // inputs a weight chunk holds (KC)
  // row stride of a chunk in shared memory: padded so that the row groups of a
  // warp read distinct banks (at KC = 4 the 16 rows of a warp are contiguous)
  static constexpr int kStride = kChunk > 4 ? kChunk + 4 : kChunk;
  static constexpr int kStageFloats = kWidest * kStride;
  static constexpr size_t kSmemBytes =
      (kPolicyTileFloats + 2 * kStageFloats + (kPolicyMaxActions + 1) * N) * sizeof(float);
  static_assert(kRowGroups * kColGroups == kPolicyThreads, "one 8 x 8 tile a thread covers the layer");
};

// Chunk [k0, k0 + KC) of layer L's weights into a stage: row m at m * kStride;
// rows >= m and inputs >= k are zero-filled.
template <int N>
__device__ __forceinline__ void load_chunk(const PolicyLayer L, int k0, float* stage) {
  using Sh = PolicyShape<N>;
  constexpr int KC = Sh::kChunk;
  if (L.vec) {
    constexpr int Q = KC / 4;
#pragma unroll
    for (int j = 0; j < Sh::kWidest * Q / kPolicyThreads; ++j) {
      const int idx = threadIdx.x + j * kPolicyThreads, row = idx / Q, k = k0 + 4 * (idx % Q);
      const bool ok = row < L.m && k < L.k;
      const float* src = ok ? L.w + static_cast<int64_t>(row) * L.k + k : L.w;
      cp_async16(stage + row * Sh::kStride + 4 * (idx % Q), src, ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < Sh::kWidest * KC / kPolicyThreads; ++j) {
      const int idx = threadIdx.x + j * kPolicyThreads, row = idx / KC, k = k0 + idx % KC;
      const bool ok = row < L.m && k < L.k;
      const float* src = ok ? L.w + static_cast<int64_t>(row) * L.k + k : L.w;
      cp_async4(stage + row * Sh::kStride + idx % KC, src, ok);
    }
  }
}

// acc[i][c] += sum over the chunk's inputs kk of w[row i][kk] * x[kk][col c], kk in order
template <int N>
__device__ __forceinline__ void chunk_product(const float* __restrict__ w, const float* __restrict__ x, int tm,
                                              int tn, float (&acc)[8][8]) {
  using Sh = PolicyShape<N>;
#pragma unroll
  for (int kq = 0; kq < Sh::kChunk; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = *reinterpret_cast<const float4*>(w + (tm + Sh::kRowGroups * i) * Sh::kStride + kq);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = x + (kq + j) * N;
      const float4 lo = *reinterpret_cast<const float4*>(row + 4 * tn);
      const float4 hi = *reinterpret_cast<const float4*>(row + N / 2 + 4 * tn);
      const float bv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = j == 0 ? a[i].x : j == 1 ? a[i].y : j == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av, bv[c], acc[i][c]);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kPolicyThreads, 2) policy_mlp_kernel(const PolicyArgs p) {
  using Sh = PolicyShape<N>;
  constexpr int R = Sh::kRowGroups, KC = Sh::kChunk;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                                       // [widest][N]: a layer's input, then its output
  float* stages = smem + kPolicyTileFloats;                // 2 x [widest][kStride]
  float* sums = stages + 2 * Sh::kStageFloats;             // [a + 1][N]
  const int tid = threadIdx.x, tn = tid % Sh::kColGroups, tm = tid / Sh::kColGroups;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * N, B = p.batch;

  // the first chunk's copy runs while the features come in
  int nl = 0, nk = KC;  // the next chunk to copy: layer, first input
  load_chunk<N>(p.layer[0], 0, stages);
  cp_async_commit();
  if (nk >= p.layer[0].k) nl = 1, nk = 0;

  // the features, zero past f (up to the last chunk's end) and past the batch
  const int in_rows = (p.f + KC - 1) / KC * KC;
  for (int idx = tid; idx < in_rows * N; idx += kPolicyThreads) {
    const int f = idx / N, n = idx % N;
    act[idx] = f < p.f && b0 + n < B ? __ldg(p.x + f * B + b0 + n) : 0.0f;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  int layer = 0, k0 = 0;
  for (int chunk = 0;; ++chunk) {
    // this chunk has landed, and every thread is done with the stage the next
    // one goes to (and with the last layer's epilogue)
    cp_async_wait_all();
    __syncthreads();
    if (nl < p.depth) {
      load_chunk<N>(p.layer[nl], nk, stages + ((chunk + 1) & 1) * Sh::kStageFloats);
      cp_async_commit();
      nk += KC;
      if (nk >= p.layer[nl].k) ++nl, nk = 0;
    }
    chunk_product<N>(stages + (chunk & 1) * Sh::kStageFloats, act + k0 * N, tm, tn, acc);
    k0 += KC;
    const PolicyLayer L = p.layer[layer];
    if (k0 < L.k) continue;
    __syncthreads();  // every thread is done reading the layer's input tile

    // the layer's epilogue: bias and tanh in registers; rows past m are zero
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = tm + R * i;
      const bool ok = m < L.m;
      const float bias = ok ? __ldg(L.b + m) : 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = ok ? tanhf(acc[i][c] + bias) : 0.0f;
    }
    if (++layer < p.depth) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = act + (tm + R * i) * N + 4 * tn;
        *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + N / 2) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
      }
      k0 = 0;
      continue;
    }

    // the heads (mu rows 0..a-1, value row a): each thread's partial over its
    // 8 rows, into [a + 1][R][N] over the finished activation tile
    const int H = L.m;
    for (int h = 0; h <= p.a; ++h) {
      const float* wh = h < p.a ? p.w_mu + static_cast<int64_t>(h) * H : p.w_v;
      float s[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[c] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tm + R * i;
        const float w = m < H ? __ldg(wh + m) : 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) s[c] = fmaf(w, acc[i][c], s[c]);
      }
      float* row = act + (h * R + tm) * N + 4 * tn;
      *reinterpret_cast<float4*>(row) = make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(row + N / 2) = make_float4(s[4], s[5], s[6], s[7]);
    }
    __syncthreads();
    // the R partials of each (head, env), row group 0 first
    for (int t = tid; t < (p.a + 1) * N; t += kPolicyThreads) {
      const int h = t / N, n = t % N;
      const float* col = act + h * R * N + n;
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s += col[r * N];
      sums[t] = s;
    }
    __syncthreads();
    break;
  }

  // the sample, an env a thread: raw = mu + exp(log_std) * eps, its log-prob
  // as (-0.5 t^2 - log_std - log(2 pi) / 2) summed over the actions, the action clamped
  if (tid < N && b0 + tid < B) {
    const int64_t e = b0 + tid;
    float* out = p.out;
    float logp = 0.0f;
    for (int h = 0; h < p.a; ++h) {
      const float mu = sums[h * N + tid] + __ldg(p.b_mu + h);
      const float log_std = __ldg(p.log_std + h);
      const float std = expf(log_std);
      const float raw = mu + std * __ldg(p.eps + h * B + e);
      const float t = (raw - mu) / std;
      logp += -0.5f * (t * t) - log_std - kHalfLog2Pi;
      out[h * B + e] = raw < -p.scale ? -p.scale : (raw > p.scale ? p.scale : raw);
      out[(p.a + h) * B + e] = raw;
    }
    out[2 * p.a * B + e] = logp;
    out[(2 * p.a + 1) * B + e] = sums[p.a * N + tid] + __ldg(p.b_v);
  }
}

template <int N>
cudaError_t launch_policy_mlp(const PolicyArgs& p, cudaStream_t s) {
  using Sh = PolicyShape<N>;
  auto kernel = policy_mlp_kernel<N>;
  // the attribute is set once a device (a context keeps it)
  static unsigned int set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(set_on >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::kSmemBytes));
    if (err != cudaSuccess) return err;
    if (dev < 32) set_on |= 1u << dev;
  }
  const int64_t blocks = (p.batch + N - 1) / N;
  kernel<<<static_cast<unsigned int>(blocks), kPolicyThreads, Sh::kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace gprt

// ptrs: x [f, batch], eps [a, batch], out [2a + 2, batch], the weight [m, k]
// and bias [m] of each trunk layer, then mu's weight [a, h] and bias [a],
// the value head's [1, h] and [1], log_std [a]: f32, contiguous, on the
// current device.  dims: f and the trunk's widths (depth + 1 ints).  tile:
// the env tile (64, 32 or 16) whose widest layer (16384 / tile) holds every
// dim.  Returns cudaErrorInvalidValue on shapes outside the kernel's limits,
// else cudaGetLastError() after the launch.
extern "C" int gprt_policy_mlp(const void* const* ptrs, const int* dims, int depth, int action_dim, int64_t batch,
                               float scale, int tile, void* stream) {
  using namespace gprt;
  // defensive: ops/kernels/policy.kernel_args holds the contract, names the limit and picks the tile
  if (depth < 1 || depth > kPolicyMaxDepth || action_dim < 1 || action_dim > kPolicyMaxActions || batch < 1 ||
      (tile != 64 && tile != 32 && tile != 16) || (batch + tile - 1) / tile > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PolicyArgs p{};
  p.x = static_cast<const float*>(ptrs[0]);
  p.eps = static_cast<const float*>(ptrs[1]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[2]));
  for (int l = 0; l <= depth; ++l) {
    if (dims[l] < 1 || dims[l] > kPolicyTileFloats / tile) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < depth; ++l) {
    PolicyLayer& L = p.layer[l];
    L.w = static_cast<const float*>(ptrs[3 + 2 * l]);
    L.b = static_cast<const float*>(ptrs[4 + 2 * l]);
    L.k = dims[l];
    L.m = dims[l + 1];
    L.vec = L.k % 4 == 0 && reinterpret_cast<uintptr_t>(L.w) % 16 == 0;
  }
  const int h = 3 + 2 * depth;
  p.w_mu = static_cast<const float*>(ptrs[h]);
  p.b_mu = static_cast<const float*>(ptrs[h + 1]);
  p.w_v = static_cast<const float*>(ptrs[h + 2]);
  p.b_v = static_cast<const float*>(ptrs[h + 3]);
  p.log_std = static_cast<const float*>(ptrs[h + 4]);
  p.depth = depth;
  p.a = action_dim;
  p.f = dims[0];
  p.scale = scale;
  p.batch = batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tile == 64 ? launch_policy_mlp<64>(p, s)
                          : tile == 32 ? launch_policy_mlp<32>(p, s)
                                       : launch_policy_mlp<16>(p, s);
  return static_cast<int>(err);
}
