"""Static tile-grid model (torch counterpart of the JAX package's ``ops/grid``).

The layout is precomputed host-side with NumPy into a frozen dataclass of
dense tensors:

- ``tile_x/tile_y``: tile-center coordinates on the full grid ``[Tx, Ty]``;
- ``layout``: the 0/1 tile layout;
- ``complete3x3``: True where the cell is the center of a full 3x3 patch;
- ``corner_onehot``/``corner_xy``: the "missing diagonal corner" sites (tiles
  whose diagonal neighbor in some direction is missing while both adjacent
  edge neighbors exist), ``[C, Tx, Ty]`` and ``[C, 2]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Dense static description of the tile table (all fields are tensors)."""

    layout: torch.Tensor  # [Tx, Ty] int32, 1 = tile present
    tile_x: torch.Tensor  # [Tx, Ty] tile center x
    tile_y: torch.Tensor  # [Tx, Ty] tile center y
    tile_size: torch.Tensor  # [3] half-extents of a tile (x, y, z)
    complete3x3: torch.Tensor  # [Tx, Ty] bool
    corner_onehot: torch.Tensor  # [C, Tx, Ty] bool (C may be 0)
    corner_xy: torch.Tensor  # [C, 2]

    @property
    def max_xy(self) -> torch.Tensor:
        """(x, y) upper corner of the grid's bounding box (the lower one is
        (0, 0))."""
        return torch.stack([self.tile_x[-1, -1] + self.tile_size[0], self.tile_y[-1, -1] + self.tile_size[1]])

    @property
    def workspace_max_xy(self) -> torch.Tensor:
        """The reference's workspace bound, the last tile centre plus half
        of the tile's half-extent (0.66 on a 3x3 table whose box ends at
        0.72): the high of the goal spaces."""
        return torch.stack([self.tile_x[-1, -1] + self.tile_size[0] / 2, self.tile_y[-1, -1] + self.tile_size[1] / 2])


# order of the four diagonal directions of the corner checks
CORNER_DIRS = ((1, -1), (1, 1), (-1, -1), (-1, 1))


def make_tile_grid(
    layout_tiles: np.ndarray, tile_size: np.ndarray | None = None, dtype=torch.float64, device=None
) -> TileGrid:
    """Build the static grid from a 0/1 layout array (host-side, NumPy).

    ``tile_size`` is the half-extent triple; the default is
    0.24/2 x 0.24/2 x 0.0352/2.  The tensors go to ``device``, the card
    unless the caller names another."""
    layout = np.asarray(layout_tiles).astype(np.int32)
    assert layout.ndim == 2, 'layout_tiles must be 2D'
    assert np.isin(layout, (0, 1)).all(), 'layout_tiles must contain only 0 and 1'
    tx, ty = layout.shape
    if tile_size is None:
        tile_size = np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2])
    tile_size = np.asarray(tile_size, dtype=np.float64)

    # tile centers: first center at half a tile width, spacing one tile width
    xs = (np.arange(tx) * 2.0 + 1.0) * tile_size[0]
    ys = (np.arange(ty) * 2.0 + 1.0) * tile_size[1]
    tile_x, tile_y = np.meshgrid(xs, ys, indexing='ij')

    pad = np.pad(layout, 1, mode='constant', constant_values=0)

    def nb(dx: int, dy: int) -> np.ndarray:
        """Neighbor-existence map: 1 if tile at (i+dx, j+dy) exists."""
        return pad[1 + dx : 1 + dx + tx, 1 + dy : 1 + dy + ty]

    complete3x3 = layout.astype(bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            complete3x3 = complete3x3 & (nb(dx, dy) == 1)

    corner_onehots: list[np.ndarray] = []
    corner_xys: list[tuple[float, float]] = []
    ii, jj = np.meshgrid(np.arange(tx), np.arange(ty), indexing='ij')
    for dx, dy in CORNER_DIRS:
        in_bounds = (ii + dx >= 0) & (ii + dx < tx) & (jj + dy >= 0) & (jj + dy < ty)
        pattern = (layout == 1) & (nb(dx, 0) == 1) & (nb(0, dy) == 1) & (nb(dx, dy) == 0) & in_bounds
        for i, j in zip(*np.nonzero(pattern)):
            onehot = np.zeros((tx, ty), dtype=bool)
            onehot[i, j] = True
            corner_onehots.append(onehot)
            corner_xys.append((tile_x[i + dx, j + dy], tile_y[i + dx, j + dy]))

    corner_onehot = np.stack(corner_onehots) if corner_onehots else np.zeros((0, tx, ty), dtype=bool)
    corner_xy = np.array(corner_xys, dtype=np.float64) if corner_xys else np.zeros((0, 2), dtype=np.float64)

    device = torch.device('cuda') if device is None else torch.device(device)

    def t(x, dt=None):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return TileGrid(
        layout=t(layout),
        tile_x=t(tile_x, dtype),
        tile_y=t(tile_y, dtype),
        tile_size=t(tile_size, dtype),
        complete3x3=t(complete3x3),
        corner_onehot=t(corner_onehot),
        corner_xy=t(corner_xy, dtype),
    )
