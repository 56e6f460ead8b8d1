"""BenchmarkPlanningEnv in PyTorch: collision-free goal reaching, 1 mover.

Counterpart of ``gymnasium_planar_robotics_tpu/models/planning.py`` for the
single-mover fused serving path: ``make_planning_env``, ``reset`` /
``init_batch``, the per-step fused APIs ``make_fused_step`` (kernel E) and
``make_fused_step_autoreset`` (kernel F), and the plane-form rollout
``make_fused_rollout`` (kernel F per step, or kernel G over chunks of K
steps).  The fused paths run the CUDA kernels of ``ops/kernels/planning``
on CUDA tensors and their plain PyTorch versions on CPU tensors.

Differences from the JAX package, by design:

- ``PlanningState`` has no ``key``: eager functions take a ``generator=``
  (a ``torch.Generator``), kernels take an integer seed and draw from a
  Philox stream inside the kernel;
- ``reset`` is batched (``reset(config, params, batch, ...)``);
- any batch size runs without padding (the kernels mask the tail block);
- ``make_planning_env`` and the numpy converters put their tensors on the
  card unless the caller passes ``device='cpu'`` (no fallback without a GPU).

Not ported yet (``NotImplementedError``, see ``ROADMAP.md``): M > 1 movers
on any path (kernel H), mesh movers, f64 on the fused paths, the eager
step (``step``, ``step_autoreset``, ``batched_step``) and
``make_reactive_rollout``.

Public layouts follow the JAX package: ``[B, 1, 2]`` for pos, vel, acc, act
and goals, ``[B]`` for steps, ``[T, B]`` rollout outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, validation
from gymnasium_planar_robotics_tpu_torch.ops.grid import TileGrid, make_tile_grid
from gymnasium_planar_robotics_tpu_torch.ops.kernels import draw_uniforms
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import walls
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import noise_probe

REWARD_SUCCESS = 50.0  # benchmark_planning_env.py:220


@dataclasses.dataclass(frozen=True)
class PlanningConfig:
    num_movers: int
    num_cycles: int = 40
    learn_jerk: bool = False
    collision_shape: str = 'circle'
    max_reset_trials: int = 100
    max_episode_steps: int = 50
    reward_mode: str = 'sparse'


@dataclasses.dataclass(frozen=True)
class PlanningParams:
    grid: TileGrid
    mover_mass: torch.Tensor  # [M]
    accel_scale: torch.Tensor  # [M]
    mover_size: torch.Tensor  # [M, 3] half-extents
    c_size: torch.Tensor  # [M] (circle) or [M, 2] (box)
    c_offset: torch.Tensor
    c_offset_wall: torch.Tensor
    std_noise: torch.Tensor  # [3] pos/vel/acc sensor noise std
    v_max: torch.Tensor
    a_max: torch.Tensor
    j_max: torch.Tensor
    threshold_pos: torch.Tensor
    initial_zpos: torch.Tensor
    dt: torch.Tensor
    min_xy: torch.Tensor  # [2] sampling bounds
    max_xy: torch.Tensor
    min_goal_dist: torch.Tensor


@dataclasses.dataclass
class PlanningState:
    pos: torch.Tensor  # [B, 1, 2]
    vel: torch.Tensor  # [B, 1, 2]
    acc: torch.Tensor  # [B, 1, 2] last applied acceleration (qacc)
    act: torch.Tensor  # [B, 1, 2] jerk-integrator activation
    goals: torch.Tensor  # [B, 1, 2]
    steps: torch.Tensor  # [B] int32


def _not_ported(what: str):
    return NotImplementedError(f'{what} is not ported yet (ROADMAP.md)')


def make_planning_env(
    layout_tiles,
    num_movers: int,
    tile_params: dict[str, Any] | None = None,
    mover_params: dict[str, Any] | None = None,
    initial_mover_zpos: float = 0.003,
    std_noise=1e-5,
    num_cycles: int = 40,
    collision_params: dict[str, Any] | None = None,
    v_max: float = 2.0,
    a_max: float = 10.0,
    j_max: float = 100.0,
    learn_jerk: bool = False,
    threshold_pos: float = 0.1,
    dtype=torch.float32,
    max_reset_trials: int = 100,
    reward_mode: str = 'sparse',
    device=None,
) -> tuple[PlanningConfig, PlanningParams]:
    """Constructor with the JAX package's kwargs and constants; bounds are
    formed in float64 NumPy and then cast.  The tensors go to ``device``:
    the card unless the caller names another."""
    device = common.resolve_device(device)
    tile_params = tile_params or {}
    mover_params = mover_params or {}
    collision_params = collision_params or {}
    layout_tiles = np.asarray(layout_tiles)

    tile_size = np.asarray(tile_params.get('size', np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2])))
    grid = make_tile_grid(layout_tiles, tile_size, dtype=dtype, device=device)

    mover_mass = np.broadcast_to(np.asarray(mover_params.get('mass', 1.24), dtype=np.float64).reshape(-1),
                                 (num_movers,))
    accel_scale = np.ones((num_movers,))
    mover_shape = mover_params.get('shape', 'box')
    if mover_shape == 'mesh':
        raise _not_ported("mover shape 'mesh'")
    assert mover_shape in ('box', 'cylinder'), f'unknown mover shape {mover_shape!r}'
    mover_size = np.asarray(mover_params.get('size', np.array([0.155 / 2, 0.155 / 2, 0.012 / 2])))
    mover_size = np.broadcast_to(mover_size.reshape(-1, 3), (num_movers, 3))

    c_shape = collision_params.get('shape', 'circle')
    c_size_in = collision_params.get('size', 0.11)
    c_offset = float(collision_params.get('offset', 0.0))
    c_offset_wall = float(collision_params.get('offset_wall', 0.0))
    c_size = common.expand_c_size(c_size_in, num_movers, c_shape, dtype, device)

    std = np.asarray(std_noise, dtype=np.float64).reshape(-1)
    std = np.broadcast_to(std, (3,)) if std.shape == (1,) else std
    assert std.shape == (3,), 'noise standard deviation has to be a float or an array of shape (3,)'

    validation.check_tile_config(layout_tiles, tile_size)
    validation.check_mover_config(num_movers, mover_size, mover_mass, initial_mover_zpos)
    validation.check_collision_params(c_shape, c_size.cpu().numpy(), mover_size, mover_shape)
    if reward_mode not in ('sparse', 'dense'):
        raise ValueError(f'unknown reward_mode {reward_mode!r}')

    # sampling bounds: the workspace (max tile center + tile_size/2) shrunk
    # by the full safety margin (the 2-vector for 'box')
    if c_shape == 'circle':
        margin = np.asarray(c_size_in).reshape(-1)[0] + c_offset + c_offset_wall
        margin = np.array([margin, margin])
    else:
        margin = np.asarray(c_size_in).reshape(-1, 2)[0] + c_offset + c_offset_wall
    hi = np.array([
        (2 * layout_tiles.shape[0] - 1) * tile_size[0] + tile_size[0] / 2,
        (2 * layout_tiles.shape[1] - 1) * tile_size[1] + tile_size[1] / 2,
    ])

    config = PlanningConfig(
        num_movers=num_movers,
        num_cycles=num_cycles,
        learn_jerk=learn_jerk,
        collision_shape=c_shape,
        max_reset_trials=max_reset_trials,
        reward_mode=reward_mode,
    )

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)

    params = PlanningParams(
        grid=grid,
        mover_mass=t(mover_mass),
        accel_scale=t(accel_scale),
        mover_size=t(mover_size),
        c_size=c_size,
        c_offset=t(c_offset),
        c_offset_wall=t(c_offset_wall),
        std_noise=t(std),
        v_max=t(v_max),
        a_max=t(a_max),
        j_max=t(j_max),
        threshold_pos=t(threshold_pos),
        initial_zpos=t(initial_mover_zpos),
        dt=t(0.001),
        min_xy=t(margin),
        max_xy=t(hi - margin),
        min_goal_dist=common.min_goal_distance(c_size, t(c_offset), c_shape),
    )
    return config, params


# ---------------------------------------------------------------------------
# numpy converters (the JAX package's leaves as numpy arrays <-> tensors)
# ---------------------------------------------------------------------------


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def params_to_numpy(params: PlanningParams) -> dict:
    """Every leaf as a numpy array; ``'grid'`` is a dict of the grid's leaves."""
    out = {f.name: _to_numpy(getattr(params, f.name)) for f in dataclasses.fields(params) if f.name != 'grid'}
    out['grid'] = {f.name: _to_numpy(getattr(params.grid, f.name)) for f in dataclasses.fields(params.grid)}
    return out


def params_from_numpy(d: dict, device=None) -> PlanningParams:
    """Build the port's params from numpy leaves (e.g. the JAX package's
    ``PlanningParams`` leaves through ``np.asarray``), on ``device`` (the
    card unless named)."""
    device = common.resolve_device(device)
    grid = TileGrid(**{f.name: torch.as_tensor(np.array(d['grid'][f.name]), device=device)
                       for f in dataclasses.fields(TileGrid)})
    leaves = {f.name: torch.as_tensor(np.array(d[f.name]), device=device)
              for f in dataclasses.fields(PlanningParams) if f.name != 'grid'}
    return PlanningParams(grid=grid, **leaves)


def state_to_numpy(state: PlanningState) -> dict:
    return {f.name: _to_numpy(getattr(state, f.name)) for f in dataclasses.fields(state)}


def state_from_numpy(d: dict, device=None) -> PlanningState:
    """Build a port state from numpy leaves on ``device`` (the card unless
    named); a JAX ``key`` leaf is dropped."""
    device = common.resolve_device(device)
    return PlanningState(**{f.name: torch.as_tensor(np.array(d[f.name]), device=device)
                            for f in dataclasses.fields(PlanningState)})


# ---------------------------------------------------------------------------
# plane layout (kernels F and G: 9 state planes)
# ---------------------------------------------------------------------------


def _a_state(config: PlanningConfig, state: PlanningState) -> torch.Tensor:
    """The kernels' control-space acceleration plane pair: the integrator
    activation in jerk mode, the last applied acceleration in acc mode."""
    return (state.act if config.learn_jerk else state.acc)[:, 0]


def state_to_planes(config: PlanningConfig, state: PlanningState) -> torch.Tensor:
    """The 9 f32 state planes ``[9, B]`` in the kernels' order."""
    cols = []
    for arr in (state.pos[:, 0], state.vel[:, 0], _a_state(config, state), state.goals[:, 0]):
        cols += [arr[:, 0], arr[:, 1]]
    cols.append(state.steps)
    return torch.stack([c.to(torch.float32) for c in cols])


def _pair(planes: torch.Tensor, i: int) -> torch.Tensor:
    return torch.stack([planes[i], planes[i + 1]], dim=-1)


def planes_to_state(config: PlanningConfig, planes: torch.Tensor, accel_scale: float) -> PlanningState:
    """The state from 9 kernel planes: qacc = accel_scale * act; ``act``
    is the integrator state in jerk mode and zero in acc mode."""
    act = _pair(planes, 4)[:, None]
    return PlanningState(
        pos=_pair(planes, 0)[:, None], vel=_pair(planes, 2)[:, None],
        acc=act * accel_scale,
        act=act if config.learn_jerk else torch.zeros_like(act),
        goals=_pair(planes, 6)[:, None], steps=planes[8].to(torch.int32),
    )


# ---------------------------------------------------------------------------
# observations, info, reward
# ---------------------------------------------------------------------------


def _norm2(d: torch.Tensor) -> torch.Tensor:
    return sqrt((d * d).sum(-1))


def _obs_vec(config: PlanningConfig, vel: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    return torch.cat([vel, acc], dim=-1) if config.learn_jerk else vel


def _get_obs(config: PlanningConfig, params: PlanningParams, state: PlanningState, generator=None) -> dict:
    """Noisy velocities (+ accelerations in jerk mode), noisy positions as
    the achieved goal."""
    b = state.pos.shape[0]
    n = noise_probe(2, b, state.pos.device, generator=generator)  # pos pair, vel pair
    pos_noisy = state.pos[:, 0] + n[0:2].T * params.std_noise[0]
    vel_noisy = state.vel[:, 0] + n[2:4].T * params.std_noise[1]
    return {
        'observation': _obs_vec(config, vel_noisy, state.acc[:, 0]),
        'achieved_goal': pos_noisy,
        'desired_goal': state.goals[:, 0],
    }


def _goal_distances(config: PlanningConfig, achieved: torch.Tensor, desired: torch.Tensor) -> torch.Tensor:
    a = achieved.reshape(*achieved.shape[:-1], config.num_movers, 2)
    d = desired.reshape(*desired.shape[:-1], config.num_movers, 2)
    return _norm2(a - d)


def _get_info(config: PlanningConfig, params: PlanningParams, obs, mover_collision, wall_collision) -> dict:
    dist = _goal_distances(config, obs['achieved_goal'], obs['desired_goal'])
    return {
        'is_success': (dist <= params.threshold_pos).all(-1) & ~mover_collision & ~wall_collision,
        'mover_collision': mover_collision,
        'wall_collision': wall_collision,
    }


def compute_reward(config: PlanningConfig, params: PlanningParams, achieved_goal, desired_goal, mover_collision,
                   wall_collision) -> torch.Tensor:
    """Batched reward: +50 all goals reached, -50 on collision, else
    -(#unreached) (sparse) or -(sum of goal distances) (dense)."""
    dist = _goal_distances(config, achieved_goal, desired_goal)
    num_reached = (dist <= params.threshold_pos).sum(-1)
    collided = mover_collision | wall_collision
    if config.reward_mode == 'dense':
        reward = torch.where(collided, -REWARD_SUCCESS, -dist.sum(-1))
    else:
        reward = torch.where(collided, -REWARD_SUCCESS, -(config.num_movers - num_reached).to(dist.dtype))
    all_reached = num_reached == config.num_movers
    return torch.where(all_reached & ~collided, REWARD_SUCCESS, reward)


# ---------------------------------------------------------------------------
# reset
# ---------------------------------------------------------------------------


def _sample_sizes(config: PlanningConfig, params: PlanningParams):
    """The reset checks' size c + offset_wall + offset, in the params' f32
    arithmetic: a float radius or an (hx, hy) pair."""
    c = (params.c_size + params.c_offset_wall + params.c_offset)[0].reshape(-1)
    return (float(c[0]), float(c[1])) if config.collision_shape == 'box' else (float(c[0]),) * 2


def _first_accepted(cands: torch.Tensor, accepts: torch.Tensor):
    """First accepted of K candidates ``[K, B, 2]`` (the last one where none
    is): (sample [B, 2], accepted [B], trials [B] int32), as the JAX
    package's bounded rejection sampler with ``block=1`` returns them."""
    k, b = accepts.shape
    ok = accepts.any(0)
    idx = torch.where(ok, torch.argmax(accepts.to(torch.int32), dim=0), k - 1)
    sample = cands.gather(0, idx[None, :, None].expand(1, b, 2))[0]
    return sample, ok, torch.where(ok, idx + 1, k).to(torch.int32)


def reset(config: PlanningConfig, params: PlanningParams, batch: int, generator: torch.Generator | None = None,
          start_xy=None, goals_xy=None):
    """Reset ``batch`` envs: start and goal each the first wall-valid of
    ``max_reset_trials`` uniform draws over ``[min_xy, max_xy]`` (identity
    orientation, size c + offset + offset_wall); then the noisy wall check
    of the start and the first observation.  ``start_xy`` / ``goals_xy``
    (``[2]``, ``[B, 2]`` or ``[B, 1, 2]``) override the sampling.

    Returns ``(state, obs, info)`` with ``reset_stalled`` (no draw accepted)
    and ``reset_trials`` (draws taken; 0 where overridden) in ``info``."""
    if config.num_movers != 1:
        raise _not_ported('reset with M > 1 movers (mover-pair and goal-separation checks)')
    device, dtype = params.min_xy.device, params.min_xy.dtype
    k = config.max_reset_trials
    box = config.collision_shape == 'box'
    rule = walls.make_wall_rule(walls.grid_np(params))
    size = _sample_sizes(config, params)

    def accept(xy):  # [..., 2] -> [...]
        return walls.sample_valid_at(rule, box, xy[..., 0], xy[..., 1], size)

    def sample():
        u = draw_uniforms(2 * k, batch, device, generator).to(dtype).reshape(k, 2, batch).transpose(1, 2)
        lo, hi = params.min_xy, params.max_xy
        cands = torch.maximum(lo, u * (hi - lo) + lo)  # [k, B, 2]
        return _first_accepted(cands, accept(cands))

    def given(xy):
        xy = torch.as_tensor(xy, dtype=dtype, device=device).reshape(-1, 2).expand(batch, 2)
        return xy, accept(xy), torch.zeros((batch,), dtype=torch.int32, device=device)

    start, start_ok, start_trials = sample() if start_xy is None else given(start_xy)
    goal, goal_ok, goal_trials = sample() if goals_xy is None else given(goals_xy)

    zeros = torch.zeros((batch, 1, 2), dtype=dtype, device=device)
    state = PlanningState(pos=start[:, None].contiguous(), vel=zeros, acc=zeros.clone(), act=zeros.clone(),
                          goals=goal[:, None].contiguous(),
                          steps=torch.zeros((batch,), dtype=torch.int32, device=device))

    # the start re-checked with sensor noise: position, and for the box the
    # quaternion around the identity (wall size with the safety offset)
    n = noise_probe(3 if box else 1, batch, device, generator=generator) * params.std_noise[0]
    R = walls.quat_to_R2(*(q + nq for q, nq in zip(common.IDENTITY_QUAT, n[2:]))) if box else walls.IDENTITY_R
    wall = ~walls.shape_valid(rule, box, start[:, 0] + n[0], start[:, 1] + n[1], R, *size)
    obs = _get_obs(config, params, state, generator)
    info = _get_info(config, params, obs, torch.zeros_like(wall), wall)
    info['reset_stalled'] = ~(start_ok & goal_ok)
    info['reset_trials'] = start_trials + goal_trials
    return state, obs, info


def init_batch(config: PlanningConfig, params: PlanningParams, batch: int, generator: torch.Generator | None = None):
    """Reset ``batch`` independent planning envs (see ``reset``)."""
    return reset(config, params, batch, generator)


# ---------------------------------------------------------------------------
# fused serving path
# ---------------------------------------------------------------------------


def _limit(config: PlanningConfig, params: PlanningParams) -> float:
    return float(params.j_max if config.learn_jerk else params.a_max)


def _scale(params: PlanningParams) -> float:
    return float(params.accel_scale.reshape(-1)[0])


def _action_planes(action: torch.Tensor, b: int, limit: float) -> torch.Tensor:
    return torch.clamp(action.to(torch.float32).reshape(b, 2), -limit, limit).T.contiguous()


def make_fused_step(config: PlanningConfig, params: PlanningParams):
    """Batched planning step with the whole cycle loop in one launch of
    kernel E; returns ``step_fn(state, action, noise=None, seed=None,
    generator=None) -> (state, obs, reward, terminated, truncated, info)``.

    ``noise``: ``[step_fn.noise_planes, B]`` uniforms for the cycles (the
    injected mode); without it CPU tensors draw them from ``generator`` and
    the kernel draws its Philox stream under ``seed`` (from ``generator``
    when not given).  The observation noise is drawn from ``generator``."""
    kc = kplan.make_kernel_consts(config, params)
    limit, scale = _limit(config, params), _scale(params)

    def step_fn(state: PlanningState, action, noise=None, seed=None, generator=None):
        b = state.pos.shape[0]
        cols = []
        for arr in (state.pos[:, 0], state.vel[:, 0], _a_state(config, state)):
            cols += [arr[:, 0], arr[:, 1]]
        planes = torch.cat([torch.stack(cols).to(torch.float32), _action_planes(action, b, limit)])
        out = kplan.planning_cycles(planes, kc, uniforms=noise, seed=seed, generator=generator)
        act = _pair(out, 4)[:, None]
        new_state = PlanningState(
            pos=_pair(out, 0)[:, None], vel=_pair(out, 2)[:, None], acc=act if scale == 1.0 else scale * act,
            act=act, goals=state.goals, steps=state.steps + 1,
        )
        wall = out[6] > 0.5
        mover = torch.zeros_like(wall)
        obs = _get_obs(config, params, new_state, generator)
        info = _get_info(config, params, obs, mover, wall)
        reward = compute_reward(config, params, obs['achieved_goal'], obs['desired_goal'], mover, wall)
        return new_state, obs, reward, reward.abs() == REWARD_SUCCESS, torch.zeros_like(wall), info

    step_fn.noise_planes = kplan.cycles_noise_planes(config.num_cycles, kc.box)
    return step_fn


def make_fused_step_autoreset(config: PlanningConfig, params: PlanningParams, cand_k: int = 16):
    """Fused planning step + episode restart in one launch of kernel F
    (cycles, termination, start/goal resampling with ``cand_k`` candidates
    each, both observations); sparse or dense reward from the pre-reset
    observation.  A stalled restart leaves the env un-reset and reports
    ``info['reset_stalled']`` (retried next step).  Same signature as
    ``make_fused_step``."""
    kc = kplan.make_kernel_consts(config, params, cand_k)
    limit, scale = _limit(config, params), _scale(params)

    def step_fn(state: PlanningState, action, noise=None, seed=None, generator=None):
        b = state.pos.shape[0]
        out = kplan.planning_autoreset(state_to_planes(config, state), _action_planes(action, b, limit), kc,
                                       uniforms=noise, seed=seed, generator=generator)
        act = _pair(out, 4)[:, None]
        acc = act if scale == 1.0 else scale * act
        new_state = PlanningState(
            pos=_pair(out, 0)[:, None], vel=_pair(out, 2)[:, None], acc=acc,
            act=act if config.learn_jerk else torch.zeros_like(act),
            goals=_pair(out, 6)[:, None], steps=out[8].to(torch.int32),
        )
        old_goal = state.goals[:, 0].to(torch.float32)
        s_v, s_ag = _pair(out, 9), _pair(out, 11)
        f_v, f_ag, f_acc = _pair(out, 13), _pair(out, 15), _pair(out, 17)
        if scale != 1.0:
            f_acc = scale * f_acc  # pre-reset qacc from the act plane
        wall, reached = out[19] > 0.5, out[20] > 0.5
        if config.reward_mode == 'dense':
            reward = torch.where(wall, -REWARD_SUCCESS, torch.where(reached, REWARD_SUCCESS, -_norm2(f_ag - old_goal)))
        else:
            reward = torch.where(wall, -REWARD_SUCCESS, torch.where(reached, REWARD_SUCCESS, -1.0))
        info = {
            'is_success': reached & ~wall,
            'mover_collision': torch.zeros_like(wall),
            'wall_collision': wall,
            'final_observation': {'observation': _obs_vec(config, f_v, f_acc), 'achieved_goal': f_ag,
                                  'desired_goal': old_goal},
            'reset_stalled': out[21] > 0.5,
            'reset_trials': out[22].to(torch.int32),
        }
        obs = {'observation': _obs_vec(config, s_v, acc[:, 0]), 'achieved_goal': s_ag,
               'desired_goal': new_state.goals[:, 0]}
        truncated = (state.steps + 1) >= config.max_episode_steps
        return new_state, obs, reward, wall | reached, truncated, info

    step_fn.noise_planes = kplan.autoreset_noise_planes(config.num_cycles, cand_k, kc.box)
    return step_fn


def _make_rollout(config: PlanningConfig, params: PlanningParams, steps_per_launch: int, step_impl, chunk_impl):
    """The rollout loop shared by ``make_fused_rollout`` and the card's
    plain-version timing: ``step_impl(planes [9, B], action [2, B], seed)
    -> [23, B]`` (one autoreset step), ``chunk_impl(planes, actions [K, 2,
    B], seed) -> (planes, [3, K, B])`` (K steps)."""
    limit, scale = _limit(config, params), _scale(params)
    max_steps = float(config.max_episode_steps)

    def rollout(state: PlanningState, actions, seed: int):
        b = state.pos.shape[0]
        actions = torch.clamp(actions.to(torch.float32).reshape(-1, b, 2), -limit, limit)
        action_planes = actions.permute(0, 2, 1).contiguous()  # [T, 2, B]
        planes = state_to_planes(config, state)
        if steps_per_launch > 1:
            # chunks of K steps, the last one shorter when K does not divide T
            sig = []
            for c, t0 in enumerate(range(0, action_planes.shape[0], steps_per_launch)):
                planes, s = chunk_impl(planes, action_planes[t0 : t0 + steps_per_launch], seed + c)
                sig.append(s)
            wall, reached, trunc = torch.cat(sig, dim=1)
        else:
            walls_, reach, truncs = [], [], []
            for t in range(action_planes.shape[0]):
                out = step_impl(planes, action_planes[t], seed + t)
                walls_.append(out[19])
                reach.append(out[20])
                truncs.append(torch.where(planes[8] + 1.0 >= max_steps, 1.0, 0.0))
                planes = out[:9]
            wall, reached, trunc = torch.stack(walls_), torch.stack(reach), torch.stack(truncs)
        rew = torch.where(wall > 0.5, -REWARD_SUCCESS, torch.where(reached > 0.5, REWARD_SUCCESS, -1.0))
        return planes_to_state(config, planes, scale), rew, torch.maximum(wall, reached) > 0.5, trunc > 0.5

    return rollout


def make_fused_rollout(config: PlanningConfig, params: PlanningParams, cand_k: int = 16, steps_per_launch: int = 1):
    """Plane-form rollout: the state stays in the kernels' ``[9, B]`` plane
    layout across all steps, actions are given up front; sparse reward.

    ``steps_per_launch == 1`` launches kernel F once per step (seed
    ``seed + t``); ``steps_per_launch = K > 1`` launches kernel G over
    chunks of K steps plus one tail chunk (seed ``seed + chunk``).  On CPU
    tensors the plain versions draw their uniforms from a generator seeded
    the same way.

    Returns ``rollout(state, actions [T, B, 2], seed) -> (final state,
    rewards [T, B], terminated [T, B], truncated [T, B])``."""
    if config.reward_mode != 'sparse':
        raise ValueError("the fused rollout computes the sparse reward in-plane; reward_mode='dense' "
                         'runs on make_fused_step_autoreset')
    kc = kplan.make_kernel_consts(config, params, cand_k)

    def _gen(planes, seed):
        return torch.Generator(device='cpu').manual_seed(seed) if planes.device.type == 'cpu' else None

    def step_impl(planes, action, seed):
        return kplan.planning_autoreset(planes, action, kc, seed=seed, generator=_gen(planes, seed))

    def chunk_impl(planes, actions, seed):
        return kplan.planning_rollout(planes, actions, kc, seed=seed, generator=_gen(planes, seed))

    return _make_rollout(config, params, steps_per_launch, step_impl, chunk_impl)


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------


def step(config, params, state, action):
    """The eager XLA-path step (``_step_core``): not ported yet."""
    raise _not_ported('the eager planning step')


def step_autoreset(config, params, state, action):
    """The eager XLA-path autoreset step: not ported yet."""
    raise _not_ported('the eager planning autoreset step')


def batched_step(config, params, state, action):
    raise _not_ported('the eager planning step')


def make_reactive_rollout(config, params, policy_step, num_steps, cand_k: int = 16, dense_reward: bool = False):
    """The reactive (policy-in-the-loop) rollout: not ported yet."""
    raise _not_ported('make_reactive_rollout')
