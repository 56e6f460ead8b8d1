"""Shared building blocks for the env families (torch)."""

from __future__ import annotations

import dataclasses

import torch

from gymnasium_planar_robotics_tpu_torch.ops import collision, walls
from gymnasium_planar_robotics_tpu_torch.ops.grid import TileGrid


def resolve_device(device) -> torch.device:
    """The device an entry point builds its tensors on: the card unless the
    caller names another (``device='cpu'``).  Without a GPU, building a
    tensor on the default raises; nothing falls back to the CPU."""
    return torch.device('cuda') if device is None else torch.device(device)


def seeded_generator(planes: torch.Tensor, seed: int) -> torch.Generator | None:
    """A CPU generator seeded ``seed`` for a plain version on CPU tensors; None
    on the card, where the kernel keys its Philox stream with ``seed``."""
    return torch.Generator(device='cpu').manual_seed(seed) if planes.device.type == 'cpu' else None


def normals(shape: tuple, dtype, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """Standard normals from ``generator`` (drawn on its device, then moved
    to ``device``), or from ``device``'s default generator."""
    gdev = generator.device if generator is not None else torch.device(device)
    return torch.randn(shape, generator=generator, device=gdev, dtype=dtype).to(device)


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


def identity_quats(shape: tuple, dtype, device) -> torch.Tensor:
    """``[*shape, 4]`` identity quaternions (w, x, y, z) = (1, 0, 0, 0), made
    on ``device`` (no copy from the host)."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def wall_collision_any(grid: TileGrid, xy: torch.Tensor, quat: torch.Tensor | None, c_size: torch.Tensor,
                       collision_shape: str) -> torch.Tensor:
    """True where any mover collides with a wall, by the dense rule
    (``walls.qpos_is_valid``): ``xy`` ``[..., M, 2]``, ``quat`` ``[..., M,
    4]`` (box only), ``c_size`` ``[M]`` radii or ``[M, 2]`` half-extents
    with any offsets.  Returns ``[...]`` bool."""
    lead, m = xy.shape[:-2], xy.shape[-2]
    c = c_size.expand(*lead, *c_size.shape).reshape(-1, *c_size.shape[1:])
    q = None if quat is None else quat.reshape(-1, 4)
    valid = walls.qpos_is_valid(grid, xy.reshape(-1, 2), c, quat=q, collision_shape=collision_shape)
    return ~valid.reshape(*lead, m).all(-1)


def mover_collision_any(xy: torch.Tensor, quat: torch.Tensor | None, c_size: torch.Tensor,
                        collision_shape: str) -> torch.Tensor:
    """True where any mover pair collides (``ops.collision``)."""
    return collision.check_mover_collision(xy, c_size, quat=quat, collision_shape=collision_shape)


def where_done(done: torch.Tensor, if_done: torch.Tensor, if_not: torch.Tensor) -> torch.Tensor:
    """``done`` ``[B]`` broadcast over a ``[B, ...]`` leaf."""
    return torch.where(done.reshape(-1, *([1] * (if_not.ndim - 1))), if_done, if_not)


def autoreset_select(done: torch.Tensor, stepped_state, reset_state):
    """The state of every field: the freshly reset one where ``done``, the
    stepped one elsewhere (field-generic, so no new state field can escape
    the restart)."""
    return dataclasses.replace(stepped_state, **{
        f.name: where_done(done, getattr(reset_state, f.name), getattr(stepped_state, f.name))
        for f in dataclasses.fields(stepped_state)})
