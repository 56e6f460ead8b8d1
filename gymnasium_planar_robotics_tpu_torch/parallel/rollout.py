"""Rollout loops over batched autoreset steps.

Counterpart of ``gymnasium_planar_robotics_tpu/parallel/rollout.py``: a
T-step loop of (policy -> step -> autoreset) whose per-step metrics stay on
the device.  The JAX package scans a vmapped per-env step under one ``jit``;
the port's steps are batched already (``step_autoreset`` and the fused
steps take ``[B, ...]``), so the loop is a plain Python loop over launches,
with nothing read back to the host.  ``rollout_loop`` and
``fused_rollout_loop`` are the port's names for ``jit_rollout`` and
``jit_rollout_fused``: with a mesh they step this rank's shard through
``parallel/sharding`` and average the metrics over the ranks.
"""

from __future__ import annotations

from typing import Callable

import torch

from gymnasium_planar_robotics_tpu_torch.parallel import sharding


def uniform_policy(action_dim: int, low, high) -> Callable:
    """Random policy: actions ~ U(low, high), independent of the
    observations; ``policy(obs, generator) -> [B, action_dim]`` f32 on the
    observations' device."""

    def policy(obs, generator):
        leaf = obs if isinstance(obs, torch.Tensor) else next(iter(obs.values()))
        gdev = generator.device if generator is not None else leaf.device
        u = torch.rand((leaf.shape[0], action_dim), generator=generator, device=gdev, dtype=torch.float32)
        return (low + (high - low) * u).to(leaf.device)

    return policy


def _metrics(reward, terminated, truncated, info) -> torch.Tensor:
    return torch.stack([reward.to(torch.float32).mean(), (terminated | truncated).to(torch.float32).mean(),
                        info['is_success'].to(torch.float32).mean()])


def _loop(step: Callable, policy: Callable, num_steps: int, mesh=None):
    n, r = (1, 0) if mesh is None else (mesh.size(), mesh.get_local_rank())

    def rollout(state, obs, generator=None):
        rows = []
        for _ in range(num_steps):
            # each rank's policy draws its own stream (the JAX policy draws the global batch)
            leaf = obs if isinstance(obs, torch.Tensor) else next(iter(obs.values()))
            actions = policy(obs, sharding.rank_generator(generator, n, r, leaf.device))
            state, obs, reward, terminated, truncated, info = step(state, actions, generator)
            rows.append(_metrics(reward, terminated, truncated, info))
        stacked = torch.stack(rows, dim=1)  # [3, T]
        if mesh is not None:
            stacked = sharding.all_reduce_mean(stacked, mesh)
        metrics = dict(zip(('reward_mean', 'done_rate', 'success_rate'), stacked.unbind()))
        return state, obs, generator, metrics

    return rollout


def make_rollout_fn(config, params, step_autoreset_fn: Callable, policy: Callable, num_steps: int):
    """``rollout(state, obs, generator) -> (state, obs, generator, metrics)``
    over ``num_steps`` autoreset steps ``step_autoreset_fn(config, params,
    state, actions, generator=...)`` (e.g. ``planning.step_autoreset``),
    actions from ``policy(obs, generator)``.  ``metrics`` holds ``[T]``
    tensors on the device: ``reward_mean``, ``done_rate`` (terminated or
    truncated) and ``success_rate``."""
    return _loop(lambda s, a, g: step_autoreset_fn(config, params, s, a, generator=g), policy, num_steps)


def make_rollout_fn_batched(batched_step: Callable, policy: Callable, num_steps: int, mesh=None):
    """The same loop over an already-batched autoreset step
    ``batched_step(state, actions, generator=...)``: a fused step
    (``models/*.make_fused_step_autoreset``) or its sharded form
    (``parallel/sharding.make_sharded_fused_step``).  With ``mesh`` the
    metrics are the global means, in one ``all_reduce`` at the end."""
    return _loop(lambda s, a, g: batched_step(s, a, generator=g), policy, num_steps, mesh)


def fused_rollout_loop(model, config, params, policy: Callable, num_steps: int, mesh=None, **fused_kw):
    """``jit_rollout_fused``: the rollout loop over the fused autoreset step
    (kernel C, F or H), on this rank's shard under ``make_sharded_fused_step``
    when ``mesh`` is given.  Raises where the configuration has no fused step
    (e.g. the dense pushing reward)."""
    if mesh is None:
        return make_rollout_fn_batched(model.make_fused_step_autoreset(config, params, **fused_kw), policy,
                                       num_steps)
    step = sharding.make_sharded_fused_step(model, config, params, mesh, **fused_kw)
    return make_rollout_fn_batched(step, policy, num_steps, mesh)


def rollout_loop(config, params, step_autoreset_fn: Callable, policy: Callable, num_steps: int, mesh=None):
    """``jit_rollout``: ``make_rollout_fn``, on this rank's shard under
    ``sharded_step_fn`` when ``mesh`` is given."""
    if mesh is None:
        return make_rollout_fn(config, params, step_autoreset_fn, policy, num_steps)
    step = sharding.sharded_step_fn(config, params, mesh, step_autoreset_fn)
    return make_rollout_fn_batched(step, policy, num_steps, mesh)
