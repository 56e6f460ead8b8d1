"""Construction-time configuration validation (numpy only).

A copy of the JAX package's ``models/validation.py``, kept here so that the
port imports nothing of the JAX package: host-side counterparts of the
reference's assertion/warning suite (``basic_envs.py:1469-1626``), run at
constructor time so that misconfiguration fails loudly.
"""

from __future__ import annotations

import warnings

import numpy as np


def check_tile_config(layout_tiles: np.ndarray, tile_size: np.ndarray) -> None:
    """basic_envs.py:1469-1486."""
    layout = np.asarray(layout_tiles)
    assert layout.ndim == 2, 'Unexpected tile layout shape. Expected: (num_tiles_x, num_tiles_y)'
    assert np.isin(layout, (0, 1)).all(), 'Use an array of only 0 and 1 to specify the tile layout.'
    assert layout.sum() > 0, 'Number of tiles must be >0.'
    tile_size = np.asarray(tile_size)
    assert tile_size.shape == (3,), 'Specify the size of a tile using an array of shape (3,)'
    assert (tile_size > 0).all(), 'Tile size must be >0.'


def check_mover_config(num_movers: int, mover_size: np.ndarray, mover_mass: np.ndarray, initial_zpos: float) -> None:
    """basic_envs.py:1488-1553 (reduced to array-shape-agnostic invariants —
    shapes are normalized by the constructors before this check)."""
    assert num_movers > 0, 'Number of movers must be >0.'
    assert (np.asarray(mover_size) > 0).all(), 'Mover size must be >0.'
    assert (np.asarray(mover_mass) > 0).all(), 'Mover mass must be >0.'
    assert initial_zpos >= 0, 'Initial mover z position must be >= 0.'


def check_collision_params(
    collision_shape: str, c_size: np.ndarray, mover_size: np.ndarray, mover_shape: str = 'box'
) -> None:
    """basic_envs.py:1555-1604, including the collision-shape-too-small
    warning: a collision shape smaller than the mover footprint means real
    mover geometry can overlap undetected."""
    assert collision_shape in ('circle', 'box'), 'Unexpected collision shape. You can choose between circle and box.'
    c = np.asarray(c_size)
    m = np.asarray(mover_size).reshape(-1, 3)
    for i in range(m.shape[0]):
        sx = m[i, 0]
        sy = m[i, 0] if mover_shape == 'cylinder' else m[i, 1]
        if collision_shape == 'circle':
            r = float(c.reshape(-1)[min(i, c.size - 1)])
            if r < np.sqrt(sx**2 + sy**2):
                warnings.warn(
                    f'Collision circle (r={r:.4f}) of mover {i} is smaller than the mover diagonal '
                    f'({np.sqrt(sx**2 + sy**2):.4f}); mover geometry can overlap without a detected collision.',
                    stacklevel=3,
                )
        else:
            row = c.reshape(-1, 2)[min(i, c.reshape(-1, 2).shape[0] - 1)]
            if row[0] < sx or row[1] < sy:
                warnings.warn(
                    f'Collision box {tuple(np.round(row, 4))} of mover {i} is smaller than the mover '
                    f'half-extents ({sx:.4f}, {sy:.4f}); mover geometry can overlap without a detected collision.',
                    stacklevel=3,
                )
