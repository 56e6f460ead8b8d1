"""Mover-mover collision in PyTorch.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/collision.py``: all
M(M-1)/2 pairs as static index arrays; circles collide where the centre
distance is at most the summed radii (per pair), boxes by the exact
16-segment rotated-rectangle test.  Batched over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops import geometry
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt


def pair_indices(num_movers: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i, j) index arrays of all mover pairs, i < j."""
    return np.triu_indices(num_movers, k=1)


_PAIRS: dict = {}


def pair_tensors(num_movers: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``pair_indices`` as tensors on ``device``, copied there once: a copy
    from the host in every step would wait for the card."""
    key = (num_movers, device)
    if key not in _PAIRS:
        _PAIRS[key] = tuple(torch.as_tensor(a, device=device) for a in pair_indices(num_movers))
    return _PAIRS[key]


def check_mover_collision(xy: torch.Tensor, c_size: torch.Tensor, quat: torch.Tensor | None = None,
                          collision_shape: str = 'circle') -> torch.Tensor:
    """Whether any two movers collide.

    ``xy`` ``[..., M, 2]``; ``c_size`` the collision sizes with any safety
    offset, ``[M]`` radii (circle) or ``[M, 2]`` half-extents (box);
    ``quat`` ``[..., M, 4]`` (box only).  Returns ``[...]`` bool."""
    m = xy.shape[-2]
    if m < 2:
        return torch.zeros(xy.shape[:-2], dtype=torch.bool, device=xy.device)
    ii, jj = pair_tensors(m, xy.device)
    if collision_shape == 'circle':
        r = c_size.reshape(m)
        d = xy[..., ii, :] - xy[..., jj, :]
        return (sqrt((d * d).sum(-1)) <= r[ii] + r[jj]).any(-1)
    if collision_shape == 'box':
        assert quat is not None, "collision_shape 'box' requires quaternions"
        c = c_size.reshape(m, 2).expand(*xy.shape[:-2], m, 2)
        qpos7 = torch.cat([xy, torch.zeros_like(xy[..., :1]), quat], -1)
        hits = geometry.check_rectangles_intersect(qpos7[..., ii, :], qpos7[..., jj, :], c[..., ii, :],
                                                   c[..., jj, :])
        return hits.any(-1)
    raise ValueError(f'unknown collision shape: {collision_shape!r}')
