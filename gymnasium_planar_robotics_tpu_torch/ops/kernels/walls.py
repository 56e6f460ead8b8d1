"""Wall validity: the layout's rule as a host-side table, and the plain
PyTorch versions of the four rules (``csrc/walls.cuh`` on the card).

Counterparts in ``gymnasium_planar_robotics_tpu/ops/pallas_step.py``:

- ``circle_valid_full``: ``_make_wall_valid``, fully populated layout;
- ``circle_valid_general``: ``_make_wall_valid_general``, holed layout;
- ``box_valid_full``: ``_make_wall_valid_box``, fully populated layout;
- ``box_valid_general``: ``_make_wall_valid_box_general``, holed layout
  with the missing-corner rectangle tests;
- ``seg_intersect``, ``quat_to_R2``: ``_seg_intersect``, ``_quat_to_R2``;
- ``wall_check`` / ``sample_valid_at``: ``_make_wall_checker``;
- ``wall_sizes``: ``_wall_sizes``, the checks' sizes of both families.

The Pallas kernels unroll the holed-layout rule over the cells at trace
time and prune each cell's terms by its static neighbours.  ``WallRule``
holds the same facts as data: per cell its four edges, its flags (tile
present, complete 3x3, the four neighbours, the four diagonal rescues) and
its missing-corner sites, packed into one f32 table the kernels walk.  Edges
are formed in float64 (``cx - tsx`` etc.) and rounded to f32 once, the
value the chip compares against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt

SEG_EPS = 1e-7  # ops/geometry epsilon semantics

CELL_FLOATS = 8  # x0, x1, y0, y1, flags, first corner, corner count, padding
CORNER_FLOATS = 4  # the missing tile's x0, x1, y0, y1
LAYOUT, COMPLETE = 1, 2
NB_XM, NB_XP, NB_YM, NB_YP = 4, 8, 16, 32  # neighbour (-1,0), (1,0), (0,-1), (0,1)
DIAG_XM_YM, DIAG_XM_YP, DIAG_XP_YM, DIAG_XP_YP = 64, 128, 256, 512  # (0,dy) and (dx,dy) both present


def grid_np(params) -> dict:
    """Static numpy snapshot of the tile grid (``pallas_step._grid_np``)."""
    g = params.grid
    return {
        'layout': to_numpy(g.layout),
        'tile_x': to_numpy(g.tile_x).astype(np.float64),
        'tile_y': to_numpy(g.tile_y).astype(np.float64),
        'tsx': float(to_numpy(g.tile_size)[0]),
        'tsy': float(to_numpy(g.tile_size)[1]),
        'complete3x3': to_numpy(g.complete3x3),
        'corner_xy': to_numpy(g.corner_xy).astype(np.float64),
        'corner_onehot': to_numpy(g.corner_onehot),
    }


def wall_sizes(config, params):
    """(step size, sample size) of the wall checks (``pallas_step._wall_sizes``):
    c + offset_wall during cycles, c + offset + offset_wall at reset
    sampling; a float radius for the circle, an (hx, hy) pair for the box."""
    off = float(to_numpy(params.c_offset))
    offw = float(to_numpy(params.c_offset_wall))
    if config.collision_shape == 'box':
        c = to_numpy(params.c_size).astype(np.float64).reshape(-1, 2)[0]
        return (float(c[0]) + offw, float(c[1]) + offw), (float(c[0]) + off + offw, float(c[1]) + off + offw)
    c = float(to_numpy(params.c_size).reshape(-1)[0])
    return c + offw, c + off + offw


def full_layout_bounds(g: dict):
    """(outer rect, interior rect or None) of a fully populated layout
    (``pallas_step._full_layout_bounds``)."""
    tile_x, tile_y = g['tile_x'], g['tile_y']
    tsx, tsy = g['tsx'], g['tsy']
    tx, ty = g['layout'].shape
    outer = (
        float(tile_x[0, 0] - tsx), float(tile_x[tx - 1, ty - 1] + tsx),
        float(tile_y[0, 0] - tsy), float(tile_y[tx - 1, ty - 1] + tsy),
    )
    if tx >= 3 and ty >= 3:
        fast = (
            float(tile_x[1, 1] - tsx), float(tile_x[tx - 2, ty - 2] + tsx),
            float(tile_y[1, 1] - tsy), float(tile_y[tx - 2, ty - 2] + tsy),
        )
    else:
        fast = None
    return outer, fast


def f32(x) -> float:
    return float(np.float32(x))


def full_rect(g: dict) -> dict:
    """The full-layout rule's constants (f32 values): outer rectangle
    x0, x1, y0, y1 and, for layouts of at least 3x3, the interior rectangle
    fx0..fy1 (``has_fast`` 1.0), else zeros."""
    (x0, x1, y0, y1), fast = full_layout_bounds(g)
    fx0, fx1, fy0, fy1 = fast if fast is not None else (0.0, 0.0, 0.0, 0.0)
    return {k: f32(v) for k, v in dict(x0=x0, x1=x1, y0=y0, y1=y1, has_fast=0.0 if fast is None else 1.0,
                                       fx0=fx0, fx1=fx1, fy0=fy0, fy1=fy1).items()}


@dataclasses.dataclass(frozen=True)
class Cell:
    edges: tuple  # f32 values x0, x1, y0, y1
    flags: int
    corners: tuple  # per missing-corner site: f32 x0, x1, y0, y1 of the missing tile


@dataclasses.dataclass(frozen=True)
class WallRule:
    """A layout's wall rule: ``full`` selects the closed form (``rect``),
    else the per-cell rule over ``cells``; ``table`` is the cells packed for
    the kernels (``csrc/walls.cuh``)."""

    full: bool
    rect: dict
    cells: tuple
    table: np.ndarray

    @property
    def n_cells(self) -> int:
        return len(self.cells)


def make_wall_rule(g: dict) -> WallRule:
    layout = g['layout']
    tile_x, tile_y = g['tile_x'], g['tile_y']
    tsx, tsy = g['tsx'], g['tsy']
    complete = g['complete3x3']
    tx, ty = layout.shape
    pad = np.pad(layout, 1)

    def nb(i, j, dx, dy):
        return bool(pad[1 + i + dx, 1 + j + dy])

    corners_by_cell: dict = {}
    for c in range(g['corner_xy'].shape[0]):
        ci, cj = np.argwhere(g['corner_onehot'][c])[0]
        ccx, ccy = float(g['corner_xy'][c, 0]), float(g['corner_xy'][c, 1])
        corners_by_cell.setdefault((int(ci), int(cj)), []).append(
            (f32(ccx - tsx), f32(ccx + tsx), f32(ccy - tsy), f32(ccy + tsy)))

    cells = []
    for i in range(tx):
        for j in range(ty):
            cx, cy = tile_x[i, j], tile_y[i, j]
            flags = (LAYOUT if layout[i, j] else 0) | (COMPLETE if complete[i, j] else 0)
            for bit, ok in ((NB_XM, nb(i, j, -1, 0)), (NB_XP, nb(i, j, 1, 0)), (NB_YM, nb(i, j, 0, -1)),
                            (NB_YP, nb(i, j, 0, 1)),
                            (DIAG_XM_YM, nb(i, j, 0, -1) and nb(i, j, -1, -1)),
                            (DIAG_XM_YP, nb(i, j, 0, 1) and nb(i, j, -1, 1)),
                            (DIAG_XP_YM, nb(i, j, 0, -1) and nb(i, j, 1, -1)),
                            (DIAG_XP_YP, nb(i, j, 0, 1) and nb(i, j, 1, 1))):
                flags |= bit if ok else 0
            cells.append(Cell(edges=(f32(cx - tsx), f32(cx + tsx), f32(cy - tsy), f32(cy + tsy)), flags=flags,
                              corners=tuple(corners_by_cell.get((i, j), ()))))
    rows, corner_rows, n_corners = [], [], 0
    for cell in cells:
        rows.append([*cell.edges, cell.flags, n_corners, len(cell.corners), 0.0])
        corner_rows += [list(c) for c in cell.corners]
        n_corners += len(cell.corners)
    table = np.concatenate([np.asarray(rows, np.float32).reshape(-1),
                            np.asarray(corner_rows, np.float32).reshape(-1)]).astype(np.float32)
    full = bool(layout.all())
    return WallRule(full=full, rect=full_rect(g) if full else {}, cells=tuple(cells), table=table)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def quat_to_R2(qw, qx, qy, qz):
    """2D block of the rotation matrix of a raw (w, x, y, z) quaternion:
    normalise, then the transforms3d construction."""
    inv = 1.0 / sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    nq = w * w + x * x + y * y + z * z
    s = 2.0 / nq
    X, Y, Z = x * s, y * s, z * s
    return 1.0 - (y * Y + z * Z), x * Y - w * Z, x * Y + w * Z, 1.0 - (x * X + z * Z)


IDENTITY_R = (1.0, 0.0, 0.0, 1.0)


def rect_vertices(px, py, R, chx: float, chy: float):
    """The rectangle's vertices in the reference order (-,-), (-,+), (+,+), (+,-)."""
    r00, r01, r10, r11 = R
    lxs, lys = (-chx, -chx, chx, chx), (-chy, chy, chy, -chy)
    vx = [px + r00 * lx + r01 * ly for lx, ly in zip(lxs, lys)]
    vy = [py + r10 * lx + r11 * ly for lx, ly in zip(lxs, lys)]
    return vx, vy


def _above_fast(rect, px, py):
    if not rect['has_fast']:
        return torch.zeros_like(px, dtype=torch.bool)
    return (px >= rect['fx0']) & (px <= rect['fx1']) & (py >= rect['fy0']) & (py <= rect['fy1'])


def circle_valid_full(rect: dict, px, py, r: float):
    """Centre above the table and the circle strictly inside the outer
    rectangle, or centre above the interior."""
    above = (px >= rect['x0']) & (px <= rect['x1']) & (py >= rect['y0']) & (py <= rect['y1'])
    inside = (px - r > rect['x0']) & (px + r < rect['x1']) & (py - r > rect['y0']) & (py + r < rect['y1'])
    return _above_fast(rect, px, py) | (above & inside)


def box_valid_full(rect: dict, px, py, R, chx: float, chy: float):
    """Centre above the table and all four rotated vertices strictly inside
    the outer rectangle, or centre above the interior."""
    above = (px >= rect['x0']) & (px <= rect['x1']) & (py >= rect['y0']) & (py <= rect['y1'])
    vx, vy = rect_vertices(px, py, R, chx, chy)
    ok = above
    for wx, wy in zip(vx, vy):
        ok = ok & (wx > rect['x0']) & (wx < rect['x1']) & (wy > rect['y0']) & (wy < rect['y1'])
    return _above_fast(rect, px, py) | ok


def _edge_rescue(f: int, m1, m2, m3, m4):
    v = m1 & m2 & m3 & m4
    if f & NB_XM:
        resc = m3 & m4
        if f & DIAG_XM_YM:
            resc = resc | ~m3
        if f & DIAG_XM_YP:
            resc = resc | ~m4
        v = v | (~m1 & resc)
    if f & NB_XP:
        resc = m3 & m4
        if f & DIAG_XP_YM:
            resc = resc | ~m3
        if f & DIAG_XP_YP:
            resc = resc | ~m4
        v = v | (~m2 & resc)
    if f & NB_YM:
        v = v | (~m3 & m1 & m2)
    if f & NB_YP:
        v = v | (~m4 & m1 & m2)
    return v


def seg_intersect(p1x, p1y, p2x, p2y, q1x, q1y, q2x, q2y):
    """Segments (p1, p2) and (q1, q2): orientation products with the epsilon
    band, AABB separation override, shared-endpoint override."""

    def pts_eq(ax, ay, bx, by):
        return (torch.abs(ax - bx) < SEG_EPS) & (torch.abs(ay - by) < SEG_EPS)

    def sep(pa, pb, qa, qb):
        mx_p, mn_q = torch.maximum(pa, pb), torch.minimum(qa, qb)
        mx_q, mn_p = torch.maximum(qa, qb), torch.minimum(pa, pb)
        pq = (mx_p < mn_q) & ~(torch.abs(mx_p - mn_q) < SEG_EPS)
        qp = (mx_q < mn_p) & ~(torch.abs(mx_q - mn_p) < SEG_EPS)
        return pq | qp

    def orient(ax, ay, bx, by, cx, cy):
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)

    eq = pts_eq(p1x, p1y, q1x, q1y) | pts_eq(p1x, p1y, q2x, q2y) | pts_eq(p2x, p2y, q1x, q1y) | pts_eq(p2x, p2y, q2x, q2y)
    minmax = sep(p1x, p2x, q1x, q2x) | sep(p1y, p2y, q1y, q2y)
    prod_p = orient(p1x, p1y, p2x, p2y, q1x, q1y) * orient(p1x, p1y, p2x, p2y, q2x, q2y)
    prod_q = orient(q1x, q1y, q2x, q2y, p1x, p1y) * orient(q1x, q1y, q2x, q2y, p2x, p2y)
    mask_o = ((prod_p <= 0) | (torch.abs(prod_p) < SEG_EPS)) & ((prod_q <= 0) | (torch.abs(prod_q) < SEG_EPS))
    return eq | (mask_o & ~minmax)


def _rect_hits_tile(vx, vy, corner):
    x0, x1, y0, y1 = (torch.full_like(vx[0], c) for c in corner)
    tvx, tvy = (x0, x0, x1, x1), (y0, y1, y1, y0)
    hit = torch.zeros_like(vx[0], dtype=torch.bool)
    for k in range(4):
        k2 = (k + 1) % 4
        for e in range(4):
            e2 = (e + 1) % 4
            hit = hit | seg_intersect(vx[k], vy[k], vx[k2], vy[k2], tvx[e], tvy[e], tvx[e2], tvy[e2])
    return hit


def _valid_general(rule: WallRule, px, py, cell_valid):
    """Valid if the centre covers a complete-3x3 cell, else if it covers some
    cell and passes the test of every cell it covers (a missing cell fails)."""
    any_above = torch.zeros_like(px, dtype=torch.bool)
    fast = torch.zeros_like(any_above)
    all_careful = torch.ones_like(any_above)
    for cell in rule.cells:
        ex0, ex1, ey0, ey1 = cell.edges
        above = (px >= ex0) & (px <= ex1) & (py >= ey0) & (py <= ey1)
        any_above = any_above | above
        if cell.flags & COMPLETE:
            fast = fast | above
            continue
        cellv = cell_valid(cell) if cell.flags & LAYOUT else torch.zeros_like(above)
        all_careful = all_careful & (~above | cellv)
    return fast | (any_above & all_careful)


def circle_valid_general(rule: WallRule, px, py, r: float):
    def cell_valid(cell):
        ex0, ex1, ey0, ey1 = cell.edges
        return _edge_rescue(cell.flags, px - r > ex0, px + r < ex1, py - r > ey0, py + r < ey1)

    return _valid_general(rule, px, py, cell_valid)


def box_valid_general(rule: WallRule, px, py, R, chx: float, chy: float):
    vx, vy = rect_vertices(px, py, R, chx, chy)

    def cell_valid(cell):
        ex0, ex1, ey0, ey1 = cell.edges
        v = torch.ones_like(px, dtype=torch.bool)
        for wx, wy in zip(vx, vy):
            v = v & _edge_rescue(cell.flags, wx > ex0, wx < ex1, wy > ey0, wy < ey1)
        for corner in cell.corners:
            v = v & ~_rect_hits_tile(vx, vy, corner)
        return v

    return _valid_general(rule, px, py, cell_valid)


def shape_valid(rule: WallRule, box: bool, px, py, R, sx: float, sy: float):
    """The layout's rule for the collision shape at (px, py): rotation ``R``
    and half-extents (sx, sy) for the box, radius ``sx`` for the circle."""
    if box:
        return box_valid_full(rule.rect, px, py, R, sx, sy) if rule.full else box_valid_general(rule, px, py, R, sx, sy)
    return circle_valid_full(rule.rect, px, py, sx) if rule.full else circle_valid_general(rule, px, py, sx)


def wall_check(rule: WallRule, box: bool, noise, px, py, std_pos: float, size: tuple):
    """The per-cycle noisy check: position noise (one normal pair), for the
    box also quaternion noise around the identity (two pairs).  True = no
    wall collision."""
    nx, ny = noise.normal_pair()
    R = IDENTITY_R
    if box:
        q1, q2 = noise.normal_pair()
        q3, q4 = noise.normal_pair()
        R = quat_to_R2(1.0 + q1 * std_pos, q2 * std_pos, q3 * std_pos, q4 * std_pos)
    return shape_valid(rule, box, px + nx * std_pos, py + ny * std_pos, R, *size)


def sample_valid_at(rule: WallRule, box: bool, sx, sy, size: tuple):
    """Reset-time acceptance: identity orientation, the sampling size."""
    return shape_valid(rule, box, sx, sy, IDENTITY_R, *size)
