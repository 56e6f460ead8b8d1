"""A third environment family built on the port's public kernel surface.

Counterpart of the JAX package's ``examples/custom_env.py``.
``ReachingEnv``: one mover must reach a goal disc and hold position inside
it for ``hold_steps`` steps.  It shows the extension contract end to end:

- config, params and a batched state as dataclasses of tensors,
- a custom per-cycle actuation law (viscous drag on the commanded
  acceleration: the actuation is just code),
- the reusable pieces: the tile grid, the wall check, the integration with
  the clamp chain, sensor noise,
- a bounded rejection-sampling reset and a latched early stop on a wall hit,
- a batched autoreset step.

Every function takes the whole batch ``[B, ...]``; the random draws come
from a ``torch.Generator``::

    python -m gymnasium_planar_robotics_tpu_torch.examples.custom_env [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.ops import dynamics, walls
from gymnasium_planar_robotics_tpu_torch.ops.grid import TileGrid, make_tile_grid


@dataclasses.dataclass(frozen=True)
class ReachingConfig:
    num_cycles: int = 40
    max_episode_steps: int = 50
    hold_steps: int = 5  # consecutive in-goal steps that make a success


@dataclasses.dataclass(frozen=True)
class ReachingParams:
    grid: TileGrid
    dt: torch.Tensor
    mass: torch.Tensor
    v_max: torch.Tensor
    a_max: torch.Tensor
    drag: torch.Tensor  # viscous drag coefficient [1/s]
    c_size: torch.Tensor  # wall-collision radius
    goal_radius: torch.Tensor
    std_noise: torch.Tensor  # [3] pos/vel/acc sensor noise
    min_xy: torch.Tensor
    max_xy: torch.Tensor


@dataclasses.dataclass
class ReachingState:
    pos: torch.Tensor  # [B, 2]
    vel: torch.Tensor  # [B, 2]
    goal: torch.Tensor  # [B, 2]
    held: torch.Tensor  # [B] consecutive in-goal steps
    steps: torch.Tensor  # [B]


def make_reaching_env(layout=None, drag=0.5, goal_radius=0.05, dtype=torch.float32, device=None):
    device = common.resolve_device(device)
    layout = np.ones((3, 3)) if layout is None else np.asarray(layout)
    grid = make_tile_grid(layout, np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2]), dtype=dtype, device=device)
    c = 0.11

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

    params = ReachingParams(
        grid=grid, dt=t(0.001), mass=t(1.24), v_max=t(2.0), a_max=t(10.0), drag=t(drag), c_size=t(c),
        goal_radius=t(goal_radius), std_noise=t([1e-5, 1e-5, 1e-5]), min_xy=t([c, c]),
        max_xy=t([layout.shape[0] * 0.24 - c, layout.shape[1] * 0.24 - c]),
    )
    return ReachingConfig(), params


def _valid(params: ReachingParams, xy: torch.Tensor) -> torch.Tensor:
    return walls.qpos_is_valid(params.grid, xy, params.c_size.expand(xy.shape[0]))


def _sample_valid_xy(params: ReachingParams, batch: int, generator=None) -> torch.Tensor:
    """Bounded rejection sampling of a wall-valid position: 16 candidates a
    env, the first valid one wins (the first candidate if none is)."""
    dev = params.min_xy.device
    gdev = generator.device if generator is not None else dev
    u = torch.rand((batch, 16, 2), generator=generator, device=gdev, dtype=params.min_xy.dtype).to(dev)
    cands = params.min_xy + u * (params.max_xy - params.min_xy)
    ok = _valid(params, cands.reshape(-1, 2)).reshape(batch, 16)
    idx = torch.argmax(ok.to(torch.int8), dim=1)  # the first valid candidate
    return cands[torch.arange(batch, device=dev), idx]


def reset(config: ReachingConfig, params: ReachingParams, batch: int, generator=None):
    pos = _sample_valid_xy(params, batch, generator)
    goal = _sample_valid_xy(params, batch, generator)
    zeros = torch.zeros((batch,), dtype=torch.int32, device=pos.device)
    state = ReachingState(pos=pos, vel=torch.zeros_like(pos), goal=goal, held=zeros, steps=zeros.clone())
    return state, _obs(params, state, generator), {}


def _obs(params: ReachingParams, state: ReachingState, generator=None):
    n = common.normals((2,) + tuple(state.pos.shape), state.pos.dtype, state.pos.device, generator)
    return {
        'observation': state.vel + params.std_noise[1] * n[1],
        'achieved_goal': state.pos + params.std_noise[0] * n[0],
        'desired_goal': state.goal,
    }


def step(config: ReachingConfig, params: ReachingParams, state: ReachingState, action, generator=None):
    action = torch.clamp(action.to(state.pos.dtype), -params.a_max, params.a_max)
    pos, vel = state.pos, state.vel
    dead = torch.zeros(pos.shape[:1], dtype=torch.bool, device=pos.device)
    for _ in range(config.num_cycles):
        # custom actuation law: the commanded acceleration minus viscous drag
        acc = action - params.drag * vel
        res = dynamics.acceleration_cycle(pos, vel, vel, acc, params.v_max, params.dt)
        # latched early stop: a dead env stops integrating (the reference's
        # break out of the cycle loop, branch-free)
        pos = torch.where(dead[:, None], pos, res.pos)
        vel = torch.where(dead[:, None], vel, res.vel)
        dead = dead | ~_valid(params, pos)
    wall_hit = dead

    in_goal = torch.linalg.vector_norm(pos - state.goal, dim=-1) <= params.goal_radius
    held = torch.where(in_goal, state.held + 1, 0)
    success = held >= config.hold_steps
    reward = torch.where(wall_hit, -50.0, torch.where(in_goal, 0.0, -1.0)).to(pos.dtype)
    terminated = wall_hit | success
    truncated = state.steps + 1 >= config.max_episode_steps
    new_state = ReachingState(pos=pos, vel=vel, goal=state.goal, held=held, steps=state.steps + 1)
    info = {'is_success': success, 'wall_collision': wall_hit}
    return new_state, _obs(params, new_state, generator), reward, terminated, truncated, info


def batched_step_autoreset(config, params, state, actions, generator=None):
    """Step, then reset where done: the shape of the built-in families'
    autoreset steps."""
    s, obs, rew, term, trunc, info = step(config, params, state, actions, generator)
    done = term | trunc
    fresh, fresh_obs, _ = reset(config, params, done.shape[0], generator)
    new_state = common.autoreset_select(done, s, fresh)
    obs = {k: common.where_done(done, fresh_obs[k], v) for k, v in obs.items()}
    return new_state, obs, rew, term, trunc, info


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args(argv)
    config, params = make_reaching_env(device=args.device)
    g = torch.Generator(device=params.dt.device).manual_seed(0)
    state, obs, _ = reset(config, params, args.batch, g)
    succ = torch.zeros((), device=params.dt.device)
    for _ in range(50):
        # greedy proportional controller toward the goal
        actions = 10.0 * (obs['desired_goal'] - obs['achieved_goal']) - 2.0 * obs['observation']
        state, obs, rew, term, trunc, info = batched_step_autoreset(config, params, state, actions, g)
        succ = succ + info['is_success'].to(torch.float32).mean()
    rate = float(succ) / 50
    print(f'ReachingEnv: 50 batched autoreset steps OK; mean success/step {rate:.3f}')
    return rate


if __name__ == '__main__':
    main()
