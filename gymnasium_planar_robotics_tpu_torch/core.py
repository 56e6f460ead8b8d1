"""Domain-core facade with the reference's method names.

Counterpart of ``gymnasium_planar_robotics_tpu/core.py``: the RL-free layer
of the reference's ``BasicPlanarRoboticsEnv`` (the tile table, the
collision configuration and the analytic collision checks) for users who
call its methods directly (custom envs, planners, validity filters).  NumPy
in, NumPy out, any number of poses at once; the checks run batched on
``device`` (the card unless named), in float64 unless told otherwise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.ops import collision as collision_ops
from gymnasium_planar_robotics_tpu_torch.ops import walls as walls_ops
from gymnasium_planar_robotics_tpu_torch.ops.grid import make_tile_grid


class PlanarRoboticsCore:
    """Tile table + collision configuration, without any RL machinery.

    :param layout_tiles: 0/1 array [num_tiles_x, num_tiles_y]
    :param tile_params: {'size': (3,) half-extents, 'mass': float}
    :param collision_params: {'shape': 'circle'|'box', 'size', 'offset',
        'offset_wall'}, the reference's defaults where not given
    """

    def __init__(self, layout_tiles: np.ndarray, tile_params: dict[str, Any] | None = None,
                 collision_params: dict[str, Any] | None = None, dtype=torch.float64, device=None):
        tile_params = tile_params or {}
        collision_params = collision_params or {}
        self.device = common.resolve_device(device)
        self.layout_tiles = np.asarray(layout_tiles).astype(np.int8)
        self.tile_size = np.asarray(tile_params.get('size', np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2])))
        self.tile_mass = tile_params.get('mass', 5.6)
        self.grid = make_tile_grid(self.layout_tiles, self.tile_size, dtype=dtype, device=self.device)
        self.c_shape = collision_params.get('shape', 'circle')
        self.c_size = collision_params.get('size', 0.11)
        self.c_size_offset = float(collision_params.get('offset', 0.0))
        self.c_size_offset_wall = float(collision_params.get('offset_wall', 0.0))
        self._dtype = dtype

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self._dtype, device=self.device)

    def _c(self, c_size, n: int) -> torch.Tensor:
        c_size = self.c_size if c_size is None else c_size
        return common.expand_c_size(c_size, n, self.c_shape, self._dtype, self.device)

    # -- the reference's method names ----------------------------------------

    def get_tile_xy_pos(self) -> tuple[np.ndarray, np.ndarray]:
        """The tile centres' coordinate grids."""
        return self.grid.tile_x.cpu().numpy(), self.grid.tile_y.cpu().numpy()

    def get_tile_indices_mask(self, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Indices of the layout windows that match a 0/1 pattern (the
        reference's anchor: the window's centre cell, biased low for even
        mask sizes), as one windowed comparison."""
        mask = np.asarray(mask)
        if mask.ndim != 2:
            raise ValueError('Unexpected shape of the mask array.')
        if not np.bitwise_or(mask == 0, mask == 1).all():
            raise ValueError('Use a numpy array of only 0 and 1 to specify the mask.')
        mx, my = mask.shape
        lay = self.layout_tiles
        if lay.shape[0] < mx or lay.shape[1] < my:
            return np.array([], dtype=int), np.array([], dtype=int)
        windows = np.lib.stride_tricks.sliding_window_view(lay, (mx, my))
        wx, wy = np.nonzero((windows == mask).all(axis=(2, 3)))
        ax = (mx // 2) if mx % 2 == 1 else (mx // 2 - 1)
        ay = (my // 2) if my % 2 == 1 else (my // 2 - 1)
        return wx + ax, wy + ay

    def get_c_size_arr(self, c_size, num_reps: int) -> np.ndarray:
        """A collision size as per-mover rows."""
        return self._c(c_size, num_reps).cpu().numpy()

    def qpos_is_valid(self, qpos: np.ndarray, c_size=None, add_safety_offset: bool = False) -> np.ndarray:
        """1 where the pose ``[N, 7]`` is clear of the walls."""
        qpos = np.asarray(qpos)
        if qpos.ndim != 2 or qpos.shape[1] != 7:
            raise ValueError('qpos must be [num_qpos, 7]')
        c = self._c(c_size, qpos.shape[0])
        c = c + self.c_size_offset_wall + (self.c_size_offset if add_safety_offset else 0.0)
        valid = walls_ops.qpos_is_valid(self.grid, self._t(qpos[:, :2]), c, quat=self._t(qpos[:, 3:]),
                                        collision_shape=self.c_shape)
        return valid.cpu().numpy().astype(int)

    def check_wall_collision(self, mover_qpos: np.ndarray, c_size=None, add_safety_offset: bool = False) -> np.ndarray:
        """1 where the mover collides with a wall."""
        return 1 - self.qpos_is_valid(mover_qpos, c_size, add_safety_offset)

    def check_mover_collision(self, mover_qpos: np.ndarray, c_size=None, add_safety_offset: bool = False) -> bool:
        """True if any two movers collide."""
        mover_qpos = np.asarray(mover_qpos)
        c = self._c(c_size, mover_qpos.shape[0]) + (self.c_size_offset if add_safety_offset else 0.0)
        hit = collision_ops.check_mover_collision(self._t(mover_qpos[:, :2]), c, quat=self._t(mover_qpos[:, 3:]),
                                                  collision_shape=self.c_shape)
        return bool(hit)
