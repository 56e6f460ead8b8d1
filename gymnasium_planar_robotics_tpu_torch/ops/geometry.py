"""Batched 2D geometry in PyTorch: segment and rotated-rectangle tests.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/geometry.py``, with the
reference's epsilon semantics (``1e-7``) and its limitation: two rectangles
intersect iff some pair of their edges cross, so a rectangle strictly inside
another reports False.  Everything is batched over leading dimensions.
"""

from __future__ import annotations

import torch

from gymnasium_planar_robotics_tpu_torch.ops import rotations

_EPS = 1e-7


def check_line_segments_intersect(p1: torch.Tensor, p2: torch.Tensor, q1: torch.Tensor,
                                  q2: torch.Tensor) -> torch.Tensor:
    """Whether segments (p1, p2) and (q1, q2) intersect; points ``[..., 2]``.

    Orientation products with an epsilon band (``|prod| < 1e-7`` counts as
    touching), overridden to False where the bounding boxes are strictly
    apart (with its own epsilon) and to True where an endpoint is shared."""

    def pts_eq(a, b):
        return (torch.abs(a - b) < _EPS).all(-1)

    points_equal = pts_eq(p1, q1) | pts_eq(p1, q2) | pts_eq(p2, q1) | pts_eq(p2, q2)
    min_p, min_q = torch.minimum(p1, p2), torch.minimum(q1, q2)
    max_p, max_q = torch.maximum(p1, p2), torch.maximum(q1, q2)
    mask_pq = (max_p < min_q) & ~(torch.abs(max_p - min_q) < _EPS)
    mask_qp = (max_q < min_p) & ~(torch.abs(max_q - min_p) < _EPS)
    minmax = (mask_pq | mask_qp).any(-1)

    def orient(a, b, c):
        return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])

    prod_p = orient(p1, p2, q1) * orient(p1, p2, q2)
    prod_q = orient(q1, q2, p1) * orient(q1, q2, p2)
    orientation = ((prod_p <= 0) | (torch.abs(prod_p) < _EPS)) & ((prod_q <= 0) | (torch.abs(prod_q) < _EPS))
    return (orientation & ~minmax) | points_equal


def get_2D_rect_vertices(qpos: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Vertices ``[..., 2, 4]`` of rectangles with poses ``qpos`` ``[..., 7]``
    (x, y, z, qw, qx, qy, qz) and half-extents ``size`` ``[..., 2]``, counter-
    clockwise from (-sx, -sy)."""
    rot = rotations.quat2mat(rotations.unit_vector(qpos[..., 3:7]))
    sx, sy = size[..., 0], size[..., 1]
    lx = torch.stack([-sx, -sx, sx, sx], -1)  # [..., 4]
    ly = torch.stack([-sy, sy, sy, -sy], -1)
    lz = torch.zeros_like(lx)
    # rot @ [lx; ly; lz], rows x and y, the products summed in order
    rows = [rot[..., r, 0, None] * lx + rot[..., r, 1, None] * ly + rot[..., r, 2, None] * lz for r in (0, 1)]
    return torch.stack(rows, -2) + qpos[..., :2, None]


def rect_edges(vertices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge start and end points ``[..., 4, 2]`` of ``[..., 2, 4]`` vertices."""
    starts = vertices.transpose(-1, -2)
    return starts, torch.roll(starts, shifts=-1, dims=-2)


def rect_vertices_intersect(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Edge-crossing test over all 16 edge pairs of ``[..., 2, 4]`` vertices."""
    s1, e1 = rect_edges(v1)
    s2, e2 = rect_edges(v2)
    p1, p2 = s1[..., :, None, :], e1[..., :, None, :]
    q1, q2 = s2[..., None, :, :], e2[..., None, :, :]
    p1, p2, q1, q2 = torch.broadcast_tensors(p1, p2, q1, q2)
    return check_line_segments_intersect(p1, p2, q1, q2).any(-1).any(-1)


def check_rectangles_intersect(qpos_r1: torch.Tensor, qpos_r2: torch.Tensor, size_r1: torch.Tensor,
                               size_r2: torch.Tensor) -> torch.Tensor:
    """Whether two rotated rectangles intersect (16 segment pairs)."""
    return rect_vertices_intersect(get_2D_rect_vertices(qpos_r1, size_r1), get_2D_rect_vertices(qpos_r2, size_r2))
