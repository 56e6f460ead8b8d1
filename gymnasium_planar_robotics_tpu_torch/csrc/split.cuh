// The producer/consumer split shared by the kernels of pushing (B, C,
// C-feat, D: pushing.cuh) and of single-mover planning (E, F, G:
// planning.cuh): a ring of stages in shared memory, its full/empty
// mbarriers, the draw sources taken by absolute index and the consumer's
// reader, and the launch shape of a block with or without the producer.
//
// A block with the producer serves one tile of 32 envs: warp 0, the
// consumer, runs each env's dependent chain from registers; the producer
// (one warp for pushing, P = kPlanningProducers warps for planning, warp
// 1 + k % P making stage k, P dividing kRingSlots so that each slot has one
// producer) computes ahead of it every value of a step that does not depend
// on the state -- per control cycle the velocity pair and the wall pose (the
// box: its rotation R), per autoreset step the family's observation normals
// and the restart's result -- and hands them over in stages.  A step is its
// cycle stages (stage_cycles<kBox>() cycles each, the last one partly filled
// when they do not divide num_cycles), then, for an autoreset step
// (Steps::kAutoreset), one step stage, which the consumer needs only after
// the cycles; a step of the cycles kernels B and E (Steps::kCycles) has
// none.  A tile's stages are numbered k = 0, 1, ... over its K steps; stage
// k lives in slot k % kRingSlots.  Draws are taken by absolute index: draw d
// of step t of env e is draw t * n_step + d of e's stream (word d % 4 of the
// Philox block at counter ((t * n_step + d) / 4, e), or injected plane t *
// n_step + d), so the values are the ones the thread-per-env arithmetic
// draws in order.  Lanes of envs >= B take part in every barrier and skip
// only their loads and stores.  Without the producer (the wide batch) there
// is no ring: every warp of a block of kInlineWarps warps draws its own
// values.

#pragma once

#include "common.cuh"

namespace gprt {

constexpr int kRingSlots = 4;     // slots of the ring
constexpr int kStageValues = 24;  // values per env of one stage
constexpr int kSplitWarps = 2;    // a block with one producer warp: consumer and producer
constexpr int kInlineWarps = 4;   // a block without the producer
constexpr int kSplitMaxThreads = 32 * (kInlineWarps > kSplitWarps ? kInlineWarps : kSplitWarps);

// values per cycle: velocity pair, wall pair, the box's R
template <bool kBox>
__host__ __device__ constexpr int cycle_values() { return kBox ? 8 : 4; }
template <bool kBox>
__host__ __device__ constexpr int stage_cycles() { return kStageValues / cycle_values<kBox>(); }

// What one step of a tile is: the cycles, then a step stage and the rest of
// the autoreset step (kernels C, D, F, G); or the cycles alone (B, E).
enum class Steps { kAutoreset, kCycles };

struct SplitShared {
  float stage[kRingSlots][kStageValues][32];
  uint64_t full[kRingSlots], empty[kRingSlots];
};

// Stage k's slot and the parity of its use of that slot.
struct RingPos {
  int slot;
  uint32_t parity;
};

__device__ __forceinline__ RingPos ring_pos(uint32_t k) {
  return {static_cast<int>(k % kRingSlots), (k / kRingSlots) & 1u};
}

// draw streams positioned at an absolute draw index; block4(env, d) returns
// the draws d .. d + 3 (d a multiple of 4: one Philox block)
struct InjectedSource {
  const float* p;
  int64_t B;
  __device__ InjectedNoise at(int64_t env, uint32_t d) const {
    InjectedNoise n(p, B, env);
    n.skip(static_cast<int>(d));
    return n;
  }
  __device__ __forceinline__ float4 block4(int64_t env, uint32_t d) const {
    const float* q = p + static_cast<int64_t>(d) * B + env;
    return make_float4(q[0], q[B], q[2 * B], q[3 * B]);
  }
};

struct PhiloxSource {
  uint64_t seed;
  __device__ PhiloxNoise at(int64_t env, uint32_t d) const {
    PhiloxNoise n(seed, env);
    n.skip(static_cast<int>(d));
    return n;
  }
  __device__ __forceinline__ float4 block4(int64_t env, uint32_t d) const {
    const uint4 w = philox4x32_10(make_uint4(d / 4u, static_cast<uint32_t>(env), 0u, 0u),
                                  make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)));
    return make_float4(bits_to_uniform(w.x), bits_to_uniform(w.y), bits_to_uniform(w.z), bits_to_uniform(w.w));
  }
};

// Values computed ahead of the physics, popped in draw order from a source
// Src with pop(): the overloads of normal_pair here and of each family's
// wall_pose take them in place of drawing, so the cycle loop is the same
// code on both.
template <class Src>
struct Popped {
  Src src;
};

template <class Src>
__device__ __forceinline__ void normal_pair(Popped<Src>& r, float& a, float& b) {
  a = r.src.pop();
  b = r.src.pop();
}

// The consumer's view of the ring.  Cycles: pop() returns the values in
// draw order and takes the next stage when the current one is spent.  The
// step's values: acquire() takes the step stage, then sv(i).  Taking a stage
// releases the one held before.
template <bool kBox>
struct RingReader {
  SplitShared* sh;
  int lane;
  uint32_t k = 0;  // stages taken so far
  int slot = -1, pos = 0, end = 0, left = 0;
  __device__ void take() {
    if (slot >= 0) mbar_arrive(&sh->empty[slot]);
    const RingPos r = ring_pos(k++);
    mbar_wait(&sh->full[r.slot], r.parity);
    slot = r.slot;
  }
  __device__ void begin_step(int num_cycles) {
    left = num_cycles;
    pos = end = 0;
  }
  __device__ __forceinline__ float pop() {
    if (pos == end) {
      take();
      const int n = left < stage_cycles<kBox>() ? left : stage_cycles<kBox>();
      left -= n;
      end = n * cycle_values<kBox>();
      pos = 0;
    }
    return sh->stage[slot][pos++][lane];
  }
  __device__ __forceinline__ void acquire() { take(); }
  __device__ __forceinline__ float operator()(int i) const { return sh->stage[slot][i][lane]; }
};

// Block, grid and dynamic shared memory of a launch over B envs with
// `producers` producer warps a block (0: without the producer).
inline int split_threads(int producers) { return 32 * (producers > 0 ? 1 + producers : kInlineWarps); }

inline size_t split_shared_bytes(int producers) { return producers > 0 ? sizeof(SplitShared) : 0; }

inline unsigned int split_blocks(int producers, int64_t B) {
  const int64_t tiles = (B + 31) / 32, per_block = producers > 0 ? 1 : kInlineWarps;
  return static_cast<unsigned int>((tiles + per_block - 1) / per_block);
}

}  // namespace gprt
