// Device helpers shared by every kernel of the port: the launch shape, the
// two noise sources (injected uniforms, in-kernel Philox4x32-10), Box-Muller,
// f32 arithmetic without contraction, the L2-ball clamp and the clamp chain
// of one mover's control cycle.
//
// Layout: one thread per env (pushing's autoreset kernels C and D: one
// consumer lane per env, pushing.cuh; kernel A: a thread per env and
// Philox block, noise_probe.cu); every input and output is an f32
// plane of B envs stored structure-of-arrays as [planes, B], so
// neighbouring threads read neighbouring addresses.  The tail block masks
// envs >= B.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// --use_fast_math (sqrtf, division, logf, cosf and sinf stay IEEE / libm
// accurate so the card agrees with the plain PyTorch versions).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gprt {

constexpr int kThreads = 128;
constexpr float kTwoPi = 6.28318530717958647692f;

inline unsigned int num_blocks(int64_t B) { return static_cast<unsigned int>((B + kThreads - 1) / kThreads); }

// ---------------------------------------------------------------------------
// f32 arithmetic that nvcc may not contract into an FMA.  PyTorch's eager
// ops round every product and every sum, and so do the Pallas kernels, so
// wherever one ulp can flip a comparison (wall rules, the clamp chain, the
// integration that feeds them) the kernels round each operation the same way.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// a + b * c with two roundings
__device__ __forceinline__ float madd(float a, float b, float c) { return __fadd_rn(a, __fmul_rn(b, c)); }
// x * x + y * y with three roundings
__device__ __forceinline__ float sq2(float x, float y) { return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)); }

// ---------------------------------------------------------------------------
// noise sources: uniform() returns the next uniform in [0, 1) of this env
// ---------------------------------------------------------------------------

// Pre-drawn uniforms [N, B]: draw d of env e is p[d * B + e], in the order
// the Pallas kernel's _InjectedNoise consumes its planes.
struct InjectedNoise {
  const float* p;
  int64_t stride;
  __device__ InjectedNoise(const float* base, int64_t batch, int64_t env) : p(base + env), stride(batch) {}
  __device__ __forceinline__ float uniform() {
    float u = *p;
    p += stride;
    return u;
  }
  // pass over n draws without reading them
  __device__ __forceinline__ void skip(int n) { p += n * stride; }
};

// Philox4x32-10 (Salmon et al., SC'11), key = the launch seed, counter =
// (draw / 4, env, 0, 0); word draw % 4 of the block becomes the uniform.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Mantissa-bitcast uniform (pallas_step._uniform): OR 23 random bits into
// the mantissa of 1.0 to get [1, 2), subtract 1.  Never returns 1.0.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The launch seed of the Philox stream: ``value``, or the int64 that ``dev``
// points to in device memory when it is not null.  A seed drawn from a
// generator on the card stays there (no copy to the host before the launch,
// and a captured graph replays the draw instead of freezing its value).
struct Seed {
  uint64_t value;
  const int64_t* dev;
  __device__ __forceinline__ uint64_t get() const {
    return dev != nullptr ? static_cast<uint64_t>(__ldg(dev)) : value;
  }
};

struct PhiloxNoise {
  uint2 key;
  uint32_t env;
  uint32_t block;
  int word;
  uint4 buf;
  __device__ PhiloxNoise(uint64_t seed, int64_t env_)
      : key(make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32))),
        env(static_cast<uint32_t>(env_)), block(0), word(4), buf(make_uint4(0, 0, 0, 0)) {}
  __device__ PhiloxNoise(const Seed& seed, int64_t env_) : PhiloxNoise(seed.get(), env_) {}
  __device__ __forceinline__ float uniform() {
    if (word == 4) {
      buf = philox4x32_10(make_uint4(block++, env, 0u, 0u), key);
      word = 0;
    }
    const uint32_t bits = word == 0 ? buf.x : word == 1 ? buf.y : word == 2 ? buf.z : buf.w;
    ++word;
    return bits_to_uniform(bits);
  }
  // pass over n draws: the next draw is the one n places further on, so the
  // stream does not shift (draw d is word d % 4 of block d / 4)
  __device__ __forceinline__ void skip(int n) {
    const uint32_t next = block * 4u - static_cast<uint32_t>(4 - word) + static_cast<uint32_t>(n);
    if (next % 4u == 0u) {
      block = next / 4u;
      word = 4;
    } else {
      buf = philox4x32_10(make_uint4(next / 4u, env, 0u, 0u), key);
      block = next / 4u + 1u;
      word = static_cast<int>(next % 4u);
    }
  }
};

// Box-Muller (pallas_step._NoiseBase.normal_pair) of the uniforms u and u2:
// u1 = 1 - u keeps the log finite
__device__ __forceinline__ void box_muller(float u, float u2, float& a, float& b) {
  const float u1 = 1.0f - u;
  const float r = sqrtf(-2.0f * logf(u1));
  const float th = kTwoPi * u2;
  a = r * cosf(th);
  b = r * sinf(th);
}

// the next normal pair of a stream: u1's uniform first, then u2's
template <class Noise>
__device__ __forceinline__ void normal_pair(Noise& noise, float& a, float& b) {
  const float u = noise.uniform();
  box_muller(u, noise.uniform(), a, b);
}

// lo + u * span (_NoiseBase.uniform_in; span = hi - lo formed on the host)
template <class Noise>
__device__ __forceinline__ float uniform_in(Noise& noise, float lo, float span) {
  return madd(lo, noise.uniform(), span);
}

// ---------------------------------------------------------------------------
// mbarriers in shared memory (sm_90): the full/empty handshake of a ring of
// stages between producer and consumer warps.  wait(parity) returns once
// the phase of that parity has completed: a consumer waits for use u of a
// slot with parity u & 1, its producer for the slot's release with
// (u & 1) ^ 1, which a fresh barrier passes at once.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival (release: this thread's earlier shared-memory writes and reads
// happen before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT_%=;\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// small helpers with JAX semantics
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// jnp.sign: -1, 0 or +1 (0 at 0, unlike copysignf)
__device__ __forceinline__ float sign0(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// L2-ball clamp (pallas_step._clamp_norm2): inclusive >=, max*v/norm order
__device__ __forceinline__ bool clamp_norm2(float x, float y, float max_val, float& cx, float& cy) {
  const float norm = sqrtf(sq2(x, y));
  const bool clamp = norm >= max_val;
  const float safe = norm > 0.0f ? norm : 1.0f;
  cx = clamp ? mul(max_val, x) / safe : x;
  cy = clamp ? mul(max_val, y) / safe : y;
  return clamp;
}

// One mover's clamp chain for one cycle (pallas_step._integrate_mover before
// the integration; the pushing cycles run the same chain).  (vmx, vmy) is
// the noisy velocity reading, (ux, uy) the action.
//   acceleration mode: returns the applied acceleration command, the action
//     unless the velocity clamp fires, then (v_clamped - v) / dt;
//   jerk mode: (amx, amy) is the measured acceleration and (bx, by) the
//     integrator state; returns the new integrator state bx + dt * jerk,
//     with the jerk re-derived when the acceleration or velocity clamp fires.
template <bool kJerk>
__device__ __forceinline__ void clamp_chain(float v_max, float a_max, float dt, float vmx, float vmy, float ux, float uy,
                                            float amx, float amy, float bx, float by, float& nx_out, float& ny_out) {
  if (kJerk) {
    const float cax0 = madd(amx, dt, ux), cay0 = madd(amy, dt, uy);
    float cax, cay;
    const bool aclamp = clamp_norm2(cax0, cay0, a_max, cax, cay);
    const float j1x = aclamp ? sub(cax, amx) / dt : ux;
    const float j1y = aclamp ? sub(cay, amy) / dt : uy;
    const float nx = madd(vmx, dt, cax), ny = madd(vmy, dt, cay);
    float cnx, cny;
    const bool vclamp = clamp_norm2(nx, ny, v_max, cnx, cny);
    const float fax = vclamp ? sub(cnx, vmx) / dt : cax;
    const float fay = vclamp ? sub(cny, vmy) / dt : cay;
    const bool diff = (fax != cax) | (fay != cay);
    const float jx = diff ? sub(fax, amx) / dt : j1x;
    const float jy = diff ? sub(fay, amy) / dt : j1y;
    nx_out = madd(bx, dt, jx);
    ny_out = madd(by, dt, jy);
  } else {
    const float nx = madd(vmx, dt, ux), ny = madd(vmy, dt, uy);
    float cnx, cny;
    const bool vclamp = clamp_norm2(nx, ny, v_max, cnx, cny);
    // the unclamped branch applies the raw action, not (v' - v) / dt
    nx_out = vclamp ? sub(cnx, vmx) / dt : ux;
    ny_out = vclamp ? sub(cny, vmy) / dt : uy;
  }
}

}  // namespace gprt
