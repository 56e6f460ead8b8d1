"""Shared building blocks for the env families (torch)."""

from __future__ import annotations

import torch


def expand_c_size(c_size, num_movers: int, collision_shape: str, dtype, device=None) -> torch.Tensor:
    """Normalize the user-facing collision size to [M] (circle) / [M, 2] (box)."""
    c = torch.as_tensor(c_size, dtype=dtype, device=device)
    if collision_shape == 'circle':
        return c.reshape(-1).broadcast_to((num_movers,))
    if c.ndim <= 1:
        return c.reshape(1, 2).broadcast_to((num_movers, 2))
    return c.reshape(num_movers, 2)
