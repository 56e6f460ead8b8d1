// Wall validity on the device: is a mover's collision shape clear of the
// imaginary walls at the tile edges?  Replaces the trace-time wall rules of
// gymnasium_planar_robotics_tpu/ops/pallas_step.py:
//
//   circle_valid_full     _make_wall_valid, fully populated layout
//   circle_valid_general  _make_wall_valid_general, holed layout
//   box_valid_full        _make_wall_valid_box, fully populated layout
//   box_valid_general     _make_wall_valid_box_general, holed layout, with
//                         the missing-corner rectangle tests
//   seg_intersect         _seg_intersect
//   quat_to_R2            _quat_to_R2
//
// The Pallas kernels unroll the holed-layout rule over the grid cells at
// trace time and prune each cell's terms by its static neighbours.  Here the
// host builds a per-cell table (ops/kernels/walls.py, WallTable) and the
// kernel walks it: every thread reads the same cell at the same time, so
// the reads are uniform across the warp.  Fully populated layouts (the main
// path) keep their closed form as a compile-time specialisation.
//
// Every product and sum is rounded on its own (common.cuh: mul/add/sub):
// one flipped flag changes the collision latch and the whole trajectory, so
// the flags must match the plain PyTorch version exactly.

#pragma once

#include "common.cuh"

namespace gprt {

constexpr float kSegEps = 1e-7f;  // ops/geometry epsilon semantics

// Table layout: kCellFloats floats per cell, then kCornerFloats per corner
// site.  Cell: edges x0, x1, y0, y1 (cx -+ tsx, cy -+ tsy formed in float64
// on the host, rounded once), flags, first corner, corner count, padding.
// Corner: the missing tile's edges x0, x1, y0, y1.
constexpr int kCellFloats = 8;
constexpr int kCornerFloats = 4;
enum CellFlag : int {
  kLayout = 1,       // tile present
  kComplete = 2,     // centre of a full 3x3 patch: covering it is valid
  kNbXm = 4,         // neighbour (-1, 0) present
  kNbXp = 8,         // (+1, 0)
  kNbYm = 16,        // (0, -1)
  kNbYp = 32,        // (0, +1)
  kDiagXmYm = 64,    // (0, -1) and (-1, -1) present
  kDiagXmYp = 128,   // (0, +1) and (-1, +1)
  kDiagXpYm = 256,   // (0, -1) and (+1, -1)
  kDiagXpYp = 512,   // (0, +1) and (+1, +1)
};

struct WallTable {
  const float* p;  // device buffer, [n_cells * kCellFloats + n_corners * kCornerFloats]
  int n_cells;
};

struct Rot2 {
  float r00, r01, r10, r11;
};

// 2D block of the rotation matrix of a raw (w, x, y, z) quaternion:
// normalise, then the transforms3d construction.  IEEE 1/sqrt, not rsqrtf.
__device__ __forceinline__ Rot2 quat_to_R2(float qw, float qx, float qy, float qz) {
  const float inv = 1.0f / sqrtf(add(add(sq2(qw, qx), mul(qy, qy)), mul(qz, qz)));
  const float w = mul(qw, inv), x = mul(qx, inv), y = mul(qy, inv), z = mul(qz, inv);
  const float nq = add(add(sq2(w, x), mul(y, y)), mul(z, z));
  const float s = 2.0f / nq;
  const float X = mul(x, s), Y = mul(y, s), Z = mul(z, s);
  Rot2 R;
  R.r00 = sub(1.0f, add(mul(y, Y), mul(z, Z)));
  R.r01 = sub(mul(x, Y), mul(w, Z));
  R.r10 = add(mul(x, Y), mul(w, Z));
  R.r11 = sub(1.0f, add(mul(x, X), mul(z, Z)));
  return R;
}

// the four rectangle vertices in the reference order (-,-), (-,+), (+,+), (+,-)
__device__ __forceinline__ void rect_vertices(float px, float py, const Rot2& R, float chx, float chy, float vx[4],
                                              float vy[4]) {
  const float lxs[4] = {-chx, -chx, chx, chx};
  const float lys[4] = {-chy, chy, chy, -chy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vx[k] = add(add(px, mul(R.r00, lxs[k])), mul(R.r01, lys[k]));
    vy[k] = add(add(py, mul(R.r10, lxs[k])), mul(R.r11, lys[k]));
  }
}

// ---------------------------------------------------------------------------
// fully populated layouts: C carries x0, x1, y0, y1 (outer rectangle) and
// has_fast, fx0, fx1, fy0, fy1 (rectangle of the complete-3x3 cells)
// ---------------------------------------------------------------------------

template <class C>
__device__ __forceinline__ bool above_fast(const C& c, float px, float py) {
  return (c.has_fast != 0.0f) & (px >= c.fx0) & (px <= c.fx1) & (py >= c.fy0) & (py <= c.fy1);
}

// centre above the table and the circle strictly inside the outer
// rectangle, or centre above the interior
template <class C>
__device__ __forceinline__ bool circle_valid_full(const C& c, float px, float py, float r) {
  const bool above = (px >= c.x0) & (px <= c.x1) & (py >= c.y0) & (py <= c.y1);
  const bool inside = (sub(px, r) > c.x0) & (add(px, r) < c.x1) & (sub(py, r) > c.y0) & (add(py, r) < c.y1);
  return above_fast(c, px, py) | (above & inside);
}

// centre above the table and all four rotated vertices strictly inside the
// outer rectangle, or centre above the interior
template <class C>
__device__ __forceinline__ bool box_valid_full(const C& c, float px, float py, const Rot2& R, float chx, float chy) {
  const bool above = (px >= c.x0) & (px <= c.x1) & (py >= c.y0) & (py <= c.y1);
  float vx[4], vy[4];
  rect_vertices(px, py, R, chx, chy, vx, vy);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) ok &= (vx[k] > c.x0) & (vx[k] < c.x1) & (vy[k] > c.y0) & (vy[k] < c.y1);
  return above_fast(c, px, py) | (above & ok);
}

// ---------------------------------------------------------------------------
// holed layouts: the per-cell rule over the table
// ---------------------------------------------------------------------------

// a point's edge tests m1..m4 (inside the cell's -x, +x, -y, +y edge) with
// the neighbour rescues: a violated edge is excused where the tile across
// it exists, a violated edge pair where the diagonal tile exists too
__device__ __forceinline__ bool edge_rescue(int f, bool m1, bool m2, bool m3, bool m4) {
  bool v = m1 & m2 & m3 & m4;
  if (f & kNbXm) {
    bool resc = m3 & m4;
    if (f & kDiagXmYm) resc |= !m3;
    if (f & kDiagXmYp) resc |= !m4;
    v |= !m1 & resc;
  }
  if (f & kNbXp) {
    bool resc = m3 & m4;
    if (f & kDiagXpYm) resc |= !m3;
    if (f & kDiagXpYp) resc |= !m4;
    v |= !m2 & resc;
  }
  if (f & kNbYm) v |= !m3 & m1 & m2;
  if (f & kNbYp) v |= !m4 & m1 & m2;
  return v;
}

__device__ __forceinline__ bool pts_eq(float ax, float ay, float bx, float by) {
  return (fabsf(sub(ax, bx)) < kSegEps) & (fabsf(sub(ay, by)) < kSegEps);
}

__device__ __forceinline__ bool aabb_sep(float pa, float pb, float qa, float qb) {
  const float mx_p = fmaxf(pa, pb), mn_q = fminf(qa, qb);
  const float mx_q = fmaxf(qa, qb), mn_p = fminf(pa, pb);
  const bool pq = (mx_p < mn_q) & !(fabsf(sub(mx_p, mn_q)) < kSegEps);
  const bool qp = (mx_q < mn_p) & !(fabsf(sub(mx_q, mn_p)) < kSegEps);
  return pq | qp;
}

__device__ __forceinline__ float orient(float ax, float ay, float bx, float by, float cx, float cy) {
  return sub(mul(sub(bx, ax), sub(cy, ay)), mul(sub(by, ay), sub(cx, ax)));
}

// segments (p1, p2) and (q1, q2): orientation products with the epsilon
// band, AABB separation override, shared-endpoint override
__device__ __forceinline__ bool seg_intersect(float p1x, float p1y, float p2x, float p2y, float q1x, float q1y,
                                              float q2x, float q2y) {
  const bool eq = pts_eq(p1x, p1y, q1x, q1y) | pts_eq(p1x, p1y, q2x, q2y) | pts_eq(p2x, p2y, q1x, q1y) |
                  pts_eq(p2x, p2y, q2x, q2y);
  const bool minmax = aabb_sep(p1x, p2x, q1x, q2x) | aabb_sep(p1y, p2y, q1y, q2y);
  const float prod_p = mul(orient(p1x, p1y, p2x, p2y, q1x, q1y), orient(p1x, p1y, p2x, p2y, q2x, q2y));
  const float prod_q = mul(orient(q1x, q1y, q2x, q2y, p1x, p1y), orient(q1x, q1y, q2x, q2y, p2x, p2y));
  const bool mask_o = ((prod_p <= 0.0f) | (fabsf(prod_p) < kSegEps)) & ((prod_q <= 0.0f) | (fabsf(prod_q) < kSegEps));
  return eq | (mask_o & !minmax);
}

// does the rectangle (vertices vx, vy) cross the missing tile's edges?
__device__ __forceinline__ bool rect_hits_tile(const float vx[4], const float vy[4], const float* corner) {
  const float tvx[4] = {corner[0], corner[0], corner[1], corner[1]};
  const float tvy[4] = {corner[2], corner[3], corner[3], corner[2]};
  for (int k = 0; k < 4; ++k) {
    const int k2 = (k + 1) & 3;
    for (int e = 0; e < 4; ++e) {
      const int e2 = (e + 1) & 3;
      if (seg_intersect(vx[k], vy[k], vx[k2], vy[k2], tvx[e], tvy[e], tvx[e2], tvy[e2])) return true;
    }
  }
  return false;
}

// The per-cell rule (ops/walls.qpos_is_valid): valid if the centre covers
// a complete-3x3 cell, else if it covers some cell and passes the test of
// every cell it covers (a missing cell fails).  A cell the centre does not
// cover passes, so its test is skipped.
template <bool kBox>
__device__ __forceinline__ bool valid_general(const WallTable& t, float px, float py, float r, const float vx[4],
                                              const float vy[4]) {
  bool any_above = false, fast = false, all_careful = true;
  for (int i = 0; i < t.n_cells; ++i) {
    const float* cell = t.p + i * kCellFloats;
    const float ex0 = cell[0], ex1 = cell[1], ey0 = cell[2], ey1 = cell[3];
    const int f = static_cast<int>(cell[4]);
    const bool above = (px >= ex0) & (px <= ex1) & (py >= ey0) & (py <= ey1);
    any_above |= above;
    if (f & kComplete) {
      fast |= above;
      continue;
    }
    if (!above) continue;
    bool cellv = false;
    if (f & kLayout) {
      if (kBox) {
        cellv = true;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cellv &= edge_rescue(f, vx[k] > ex0, vx[k] < ex1, vy[k] > ey0, vy[k] < ey1);
        }
        const int c0 = static_cast<int>(cell[5]), nc = static_cast<int>(cell[6]);
        const float* corners = t.p + t.n_cells * kCellFloats;
        for (int j = 0; j < nc && cellv; ++j) cellv = !rect_hits_tile(vx, vy, corners + (c0 + j) * kCornerFloats);
      } else {
        cellv = edge_rescue(f, sub(px, r) > ex0, add(px, r) < ex1, sub(py, r) > ey0, add(py, r) < ey1);
      }
    }
    all_careful &= cellv;
  }
  return fast | (any_above & all_careful);
}

__device__ __forceinline__ bool circle_valid_general(const WallTable& t, float px, float py, float r) {
  const float none[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  return valid_general<false>(t, px, py, r, none, none);
}

__device__ __forceinline__ bool box_valid_general(const WallTable& t, float px, float py, const Rot2& R, float chx,
                                                  float chy) {
  float vx[4], vy[4];
  rect_vertices(px, py, R, chx, chy, vx, vy);
  return valid_general<true>(t, px, py, 0.0f, vx, vy);
}

}  // namespace gprt
