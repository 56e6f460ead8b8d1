"""Shared building blocks for the env families (torch)."""

from __future__ import annotations

import torch

from gymnasium_planar_robotics_tpu_torch.ops import collision
from gymnasium_planar_robotics_tpu_torch.ops.kernels import walls

IDENTITY_QUAT = (1.0, 0.0, 0.0, 0.0)


def resolve_device(device) -> torch.device:
    """The device an entry point builds its tensors on: the card unless the
    caller names another (``device='cpu'``).  Without a GPU, building a
    tensor on the default raises; nothing falls back to the CPU."""
    return torch.device('cuda') if device is None else torch.device(device)


def seeded_generator(planes: torch.Tensor, seed: int) -> torch.Generator | None:
    """A CPU generator seeded ``seed`` for a plain version on CPU tensors; None
    on the card, where the kernel keys its Philox stream with ``seed``."""
    return torch.Generator(device='cpu').manual_seed(seed) if planes.device.type == 'cpu' else None


def stack_batch_last(items: list):
    """Stack per-step values (a tensor, or a nested tuple of tensors, each
    with the batch as its last axis) over steps, batch moved to axis 1:
    ``[A, B]`` steps give ``[T, B, A]``, ``[B]`` steps ``[T, B]``."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.movedim(torch.stack(items), -1, 1)
    return type(first)(stack_batch_last(list(leaf)) for leaf in zip(*items))


def expand_c_size(c_size, num_movers: int, collision_shape: str, dtype, device) -> torch.Tensor:
    """Normalize the user-facing collision size to [M] (circle) / [M, 2] (box)."""
    c = torch.as_tensor(c_size, dtype=dtype, device=device)
    if collision_shape == 'circle':
        return c.reshape(-1).broadcast_to((num_movers,))
    if c.ndim <= 1:
        return c.reshape(1, 2).broadcast_to((num_movers, 2))
    return c.reshape(num_movers, 2)


def min_goal_distance(c_size: torch.Tensor, c_offset: torch.Tensor, collision_shape: str) -> torch.Tensor:
    """Minimum distance between any two sampled goals
    (benchmark_planning_env.py:269-274; uses the first mover's size)."""
    if collision_shape == 'circle':
        return 2.0 * (c_size[0] + c_offset)
    v = c_size[0] + c_offset
    return 2.0 * torch.sqrt((v * v).sum().to(torch.float64)).to(v.dtype)


def wall_collision_any(rule: walls.WallRule, xy: torch.Tensor, quat: torch.Tensor | None, sizes,
                       collision_shape: str) -> torch.Tensor:
    """True where any mover collides with a wall, by the layout's rule
    (``walls.shape_valid``).  ``xy`` ``[..., M, 2]``, ``quat`` ``[..., M, 4]``
    (box only), ``sizes`` one (sx, sy) per mover (radius in sx for the
    circle, half-extents for the box)."""
    box = collision_shape == 'box'
    hit = torch.zeros(xy.shape[:-1], dtype=torch.bool, device=xy.device).any(-1)
    for i, (sx, sy) in enumerate(sizes):
        R = walls.quat_to_R2(*quat[..., i, :].unbind(-1)) if box else walls.IDENTITY_R
        hit = hit | ~walls.shape_valid(rule, box, xy[..., i, 0], xy[..., i, 1], R, sx, sy)
    return hit


def mover_collision_any(xy: torch.Tensor, quat: torch.Tensor | None, c_size: torch.Tensor,
                        collision_shape: str) -> torch.Tensor:
    """True where any mover pair collides (``ops.collision``)."""
    return collision.check_mover_collision(xy, c_size, quat=quat, collision_shape=collision_shape)
