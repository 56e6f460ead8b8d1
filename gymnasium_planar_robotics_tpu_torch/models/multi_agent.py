"""Batched multi-agent planning in PyTorch: per-agent views of the fused step.

Counterpart of ``gymnasium_planar_robotics_tpu/models/multi_agent.py`` (N
agents x B batched envs): the planning physics stepped as one fused call,
with observations, actions and rewards exposed per agent as stacked tensors
``[B, N, ...]``.  Per agent: its own velocity (and acceleration in jerk
mode) as observation, its own position and goal as achieved and desired
goal, shared-fate termination, reward +-50 on a shared success or collision,
else -1 if its own goal is not reached.

The step runs ``planning.make_fused_step_autoreset`` where a fused kernel
covers the configuration (f32 params, at most ``MAX_MOVERS`` movers), and
``planning.batched_step_autoreset`` (the eager step) elsewhere, as the JAX
package falls back to its XLA path; the device of the tensors picks the
kernel or its plain version (there is no backend switch, and no ``jit``
knob).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymnasium_planar_robotics_tpu_torch.models import planning
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt
from gymnasium_planar_robotics_tpu_torch.ops.kernels.planning_multi import MAX_MOVERS


class AgentBatch(NamedTuple):
    """Per-agent stacked views: leading dims [B, N_agents, ...]."""

    observation: torch.Tensor  # [B, N, 2] own velocity (or [B, N, 4] with accel)
    achieved_goal: torch.Tensor  # [B, N, 2]
    desired_goal: torch.Tensor  # [B, N, 2]
    reward: torch.Tensor  # [B, N]
    terminated: torch.Tensor  # [B, N] (shared fate: identical across N)
    truncated: torch.Tensor  # [B, N]


def split_obs(config: planning.PlanningConfig, obs: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched obs dict -> per-agent (observation, achieved, desired)."""
    m = config.num_movers
    lead = obs['observation'].shape[:-1]
    vel = obs['observation'][..., : m * 2].reshape(*lead, m, 2)
    achieved = obs['achieved_goal'].reshape(*lead, m, 2)
    desired = obs['desired_goal'].reshape(*lead, m, 2)
    if config.learn_jerk:
        acc = obs['observation'][..., m * 2:].reshape(*lead, m, 2)
        return torch.cat([vel, acc], -1), achieved, desired
    return vel, achieved, desired


def per_agent_rewards(config, params, achieved, desired, reward_shared):
    """Split the shared planning reward into per-agent terms: shared +-50
    events broadcast, otherwise -1 per unreached own goal."""
    d = achieved - desired
    reached = sqrt((d * d).sum(-1)) <= params.threshold_pos  # [..., N]
    shared_event = torch.abs(reward_shared) == planning.REWARD_SUCCESS
    own = -(~reached).to(achieved.dtype)
    return torch.where(shared_event[..., None], reward_shared[..., None].to(own.dtype), own)


def fused_covers(config: planning.PlanningConfig, params: planning.PlanningParams) -> bool:
    """Whether a fused kernel steps this configuration: f32 params and at
    most ``MAX_MOVERS`` movers (kernel F for one, H for more)."""
    return params.v_max.dtype == torch.float32 and config.num_movers <= MAX_MOVERS


def make_batched_parallel_step(config: planning.PlanningConfig, params: planning.PlanningParams):
    """Returns ``step(state, actions [B, N, 2], noise=None, seed=None,
    generator=None) -> (state, AgentBatch)`` over the batched
    ``PlanningState``.  ``noise`` and ``generator`` go to the step taken:
    the fused step's uniforms where ``fused_covers``, else the eager step's
    standard normals (``planning.draw_step_noise``); ``seed`` keys the fused
    step's Philox stream (the eager step takes none)."""
    n = config.num_movers
    fused_step = planning.make_fused_step_autoreset(config, params) if fused_covers(config, params) else None

    def step(state, actions, noise=None, seed=None, generator=None):
        b = actions.shape[0]
        flat = actions.reshape(b, n * 2)
        if fused_step is not None:
            out = fused_step(state, flat, noise=noise, seed=seed, generator=generator)
        else:
            out = planning.batched_step_autoreset(config, params, state, flat, noise=noise, generator=generator)
        state, obs, reward, terminated, truncated, info = out
        observation, achieved, desired = split_obs(config, obs)
        # rewards come from the episode's final observation: on done steps
        # ``obs`` is already the next episode's first one
        _, f_achieved, f_desired = split_obs(config, info['final_observation'])
        out = AgentBatch(
            observation=observation, achieved_goal=achieved, desired_goal=desired,
            reward=per_agent_rewards(config, params, f_achieved, f_desired, reward),
            terminated=terminated[..., None].expand(*terminated.shape, n),
            truncated=truncated[..., None].expand(*truncated.shape, n),
        )
        return state, out

    step.noise_planes = None if fused_step is None else fused_step.noise_planes
    return step
