"""The dense wall rule: is a mover position clear of every tile-edge wall?

Counterpart of ``gymnasium_planar_robotics_tpu/ops/walls.py``
(``qpos_is_valid``): the reference's decision procedure evaluated densely
over the ``[Q, Tx, Ty]`` cube of (position, grid cell) pairs with masks, no
data-dependent shapes.  It is the rule of the resets and the eager steps;
the fused kernels keep their per-cell table (``ops/kernels/walls.py``),
which agrees with it wherever a collision size and its offsets stay within
the tile's half-size.

Semantics, as in the JAX package:

- a position covers every grid cell whose footprint contains it, bounds
  inclusive, missing-tile cells included;
- covering a tile whose whole 3x3 neighbourhood exists makes it valid;
- otherwise it must be valid for every covered cell: inside that cell's
  edges by a strict margin, where a crossed edge (or pair of edges, through
  the diagonal terms) is excused when the adjacent (diagonal) tiles exist;
- for the box, all four rectangle vertices pass the edge tests, and at the
  missing-diagonal-corner sites the rectangle must not cross the missing
  tile's rectangle;
- a position covering no cell is invalid.

Works in any float dtype; batched over ``Q`` positions.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from gymnasium_planar_robotics_tpu_torch.ops import geometry
from gymnasium_planar_robotics_tpu_torch.ops.grid import TileGrid


def _neighbor(layout: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """``[Tx, Ty]`` bool: a tile exists at (i + dx, j + dy) (False out of bounds)."""
    tx, ty = layout.shape
    pad = torch.zeros((tx + 2, ty + 2), dtype=layout.dtype, device=layout.device)
    pad[1:-1, 1:-1] = layout
    return pad[1 + dx : 1 + dx + tx, 1 + dy : 1 + dy + ty] == 1


# the layout's masks by grid (its layout tensor), made once: the eager
# steps test the walls in every control cycle
_MASKS = WeakIdKeyDictionary()


def _layout_masks(layout: torch.Tensor) -> dict:
    """The tile mask ``L`` and the neighbour-existence excuses ``ex_*``,
    ``[Tx, Ty]`` bool each."""
    if layout not in _MASKS:
        L = layout == 1
        nb = {(dx, dy): _neighbor(layout, dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)}
        _MASKS[layout] = {
            'L': L, 'ex_minx': L & nb[-1, 0], 'ex_maxx': L & nb[1, 0], 'ex_miny': L & nb[0, -1],
            'ex_maxy': L & nb[0, 1], 'ex_minx_miny': L & nb[0, -1] & nb[-1, -1],
            'ex_minx_maxy': L & nb[0, 1] & nb[-1, 1], 'ex_maxx_miny': L & nb[0, -1] & nb[1, -1],
            'ex_maxx_maxy': L & nb[0, 1] & nb[1, 1],
        }
    return _MASKS[layout]


def _edge_and_rescue_valid(grid: TileGrid, px, py, cx, cy) -> torch.Tensor:
    """Per-(position, cell) edge validity with the neighbours' rescues.

    ``px, py, cx, cy`` ``[Q, V]`` (per-vertex coordinates and margins, V = 1
    for the circle); returns ``[Q, Tx, Ty]`` bool, all V vertices valid."""
    mk = _layout_masks(grid.layout)
    L = mk['L']
    tsx, tsy = grid.tile_size[0], grid.tile_size[1]
    px, py, cx, cy = (t[..., None, None] for t in (px, py, cx, cy))  # [Q, V, 1, 1]
    min_x, max_x = grid.tile_x - tsx, grid.tile_x + tsx
    min_y, max_y = grid.tile_y - tsy, grid.tile_y + tsy

    # strict-margin edge tests, gated on the tile existing
    m_minx = L & (min_x < px - cx)
    m_maxx = L & (px + cx < max_x)
    m_miny = L & (min_y < py - cy)
    m_maxy = L & (py + cy < max_y)

    # neighbour-existence excuses
    ex_minx, ex_maxx, ex_miny, ex_maxy = mk['ex_minx'], mk['ex_maxx'], mk['ex_miny'], mk['ex_maxy']
    ex_minx_miny, ex_minx_maxy = mk['ex_minx_miny'], mk['ex_minx_maxy']
    ex_maxx_miny, ex_maxx_maxy = mk['ex_maxx_miny'], mk['ex_maxx_maxy']

    u_minx = ~m_minx & ex_minx
    u_maxx = ~m_maxx & ex_maxx

    valid = m_minx & m_maxx & m_miny & m_maxy
    valid = valid | (u_minx & ((m_miny & m_maxy) | (~m_miny & ex_minx_miny) | (~m_maxy & ex_minx_maxy)))
    valid = valid | (u_maxx & ((m_miny & m_maxy) | (~m_miny & ex_maxx_miny) | (~m_maxy & ex_maxx_maxy)))
    valid = valid | ((~m_miny & ex_miny) & m_minx & m_maxx)
    valid = valid | ((~m_maxy & ex_maxy) & m_minx & m_maxx)
    return valid.all(dim=-3)


def qpos_is_valid(grid: TileGrid, xy: torch.Tensor, c_size: torch.Tensor, quat: torch.Tensor | None = None,
                  collision_shape: str = 'circle') -> torch.Tensor:
    """Whether each (x, y) position is clear of the walls.

    ``xy`` ``[Q, 2]``; ``c_size`` the collision size with any safety offsets
    the caller wants, ``[Q]`` radii (circle) or ``[Q, 2]`` half-extents
    (box), or anything that broadcasts to them; ``quat`` ``[Q, 4]`` (w, x,
    y, z), box only.  Returns ``[Q]`` bool, True where valid."""
    q = xy.shape[0]
    x, y = xy[:, 0], xy[:, 1]
    tsx, tsy = grid.tile_size[0], grid.tile_size[1]
    xq, yq = x[:, None, None], y[:, None, None]
    above = ((grid.tile_x - tsx <= xq) & (xq <= grid.tile_x + tsx)
             & (grid.tile_y - tsy <= yq) & (yq <= grid.tile_y + tsy))  # [Q, Tx, Ty]

    if collision_shape == 'circle':
        c = c_size.reshape(-1).expand(q)
        valid_cell = _edge_and_rescue_valid(grid, x[:, None], y[:, None], c[:, None], c[:, None])
    elif collision_shape == 'box':
        assert quat is not None, "collision_shape 'box' requires quaternions"
        c = c_size.reshape(-1, 2).expand(q, 2)
        qpos7 = torch.cat([xy, torch.zeros_like(xy[:, :1]), quat], dim=-1)
        verts = geometry.get_2D_rect_vertices(qpos7, c)  # [Q, 2, 4]
        zeros = torch.zeros_like(verts[:, 0])
        valid_cell = _edge_and_rescue_valid(grid, verts[:, 0], verts[:, 1], zeros, zeros)
        # missing-diagonal-corner sites: the rectangle must not reach into
        # the missing tile
        n_corners = grid.corner_onehot.shape[0]
        if n_corners:
            ident = torch.zeros((n_corners, 4), dtype=xy.dtype, device=xy.device)
            ident[:, 0] = 1.0
            corner_qpos = torch.cat([grid.corner_xy, torch.zeros_like(grid.corner_xy[:, :1]), ident], dim=-1)
            tile_half = grid.tile_size[:2].expand(n_corners, 2)
            hit = geometry.check_rectangles_intersect(qpos7[:, None], corner_qpos[None], c[:, None],
                                                      tile_half[None])  # [Q, C]
            fail = (hit[:, :, None, None] & grid.corner_onehot[None]).any(dim=1)
            valid_cell = valid_cell & ~fail
    else:
        raise ValueError(f'unknown collision shape: {collision_shape!r}')

    fast = (above & grid.complete3x3).flatten(1).any(-1)
    careful = (~above | valid_cell).flatten(1).all(-1) & above.flatten(1).any(-1)
    return fast | careful
