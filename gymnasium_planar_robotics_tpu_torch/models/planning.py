"""BenchmarkPlanningEnv in PyTorch: collision-free goal reaching, M movers.

Counterpart of ``gymnasium_planar_robotics_tpu/models/planning.py``:
``make_planning_env``, ``reset`` / ``init_batch``, the eager step
(``step``, ``step_with_cycles``, ``step_autoreset`` for any number of
movers; 40 control cycles of torch ops with the dense wall rule, the XLA
path of the JAX package), the per-step fused APIs ``make_fused_step`` (kernel E, 1 mover) and
``make_fused_step_autoreset`` (kernel F for 1 mover, kernel H for 2 to 64), and
the plane-form rollout ``make_fused_rollout`` (1 mover: kernel F per step or
kernel G over chunks of K steps; M movers: kernel H per step), and the
policy-in-the-loop ``make_reactive_rollout`` (1 mover, kernel F per step;
PPO's training rollout).  The fused paths run the CUDA kernels of ``ops/kernels/planning`` and
``ops/kernels/planning_multi`` on CUDA tensors and their plain PyTorch
versions on CPU tensors.

Differences from the JAX package, by design:

- ``PlanningState`` has no ``key``: eager functions take a ``generator=``
  (a ``torch.Generator`` on the state's device) and, for parity tests,
  pre-drawn standard normals (``noise=``), kernels take an integer seed and
  draw from a Philox stream inside the kernel;
- every function is batched (``reset(config, params, batch, ...)``; the
  state carries the batch as its leading axis, so ``batched_step`` is
  ``step``);
- any batch size runs without padding (the kernels mask the tail block);
- ``make_planning_env`` and the numpy converters put their tensors on the
  card unless the caller passes ``device='cpu'`` (no fallback without a GPU).

The fused paths run in f32 (the eager step takes f64), as in the JAX
package, and take up to ``planning_multi.MAX_MOVERS`` (64) movers, the most
kernel H lays over a group of lanes (more raise ``NotImplementedError``; the
eager step takes any number).
``make_fused_step`` and ``make_reactive_rollout`` cover 1 mover, as in the
JAX package (``pallas_step.supports``).

Public layouts follow the JAX package: ``[B, M, 2]`` for pos, vel, acc, act
and goals, ``[B]`` for steps, ``[T, B]`` rollout outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, validation
from gymnasium_planar_robotics_tpu_torch.models.common import autoreset_select
from gymnasium_planar_robotics_tpu_torch.models.common import where_done as _where_done
from gymnasium_planar_robotics_tpu_torch.ops import collision, dynamics
from gymnasium_planar_robotics_tpu_torch.ops.grid import TileGrid, make_tile_grid
from gymnasium_planar_robotics_tpu_torch.ops.kernels import draw_uniforms
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import noise_probe
from gymnasium_planar_robotics_tpu_torch.utils import meshes

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
    pos: torch.Tensor  # [B, M, 2]
    vel: torch.Tensor  # [B, M, 2]
    acc: torch.Tensor  # [B, M, 2] last applied acceleration (qacc)
    act: torch.Tensor  # [B, M, 2] jerk-integrator activation
    goals: torch.Tensor  # [B, M, 2]
    steps: torch.Tensor  # [B] int32


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
        # size from the (scaled) mesh AABB; a bumper geom carries its own
        # mass on the same body while the actuator gain stays the configured
        # mover mass, so the real acceleration is the command scaled by
        # m_gain / m_total
        mesh_cfg = mover_params.get('mesh', {})
        mover_size = meshes.resolve_mover_size('mesh', None, mesh_cfg.get('mover_stl_path', 'beckhoff_apm4330_mover'),
                                               mesh_cfg.get('scale', (1.0, 1.0, 1.0)))
        mover_size = np.broadcast_to(mover_size.reshape(-1, 3), (num_movers, 3))
        if mesh_cfg.get('bumper_stl_path', 'beckhoff_apm4330_bumper') is not None:
            bumper_mass = np.broadcast_to(np.asarray(mesh_cfg.get('bumper_mass', 0.1), dtype=np.float64).reshape(-1),
                                          (num_movers,))
            assert (bumper_mass >= 0).all(), 'Bumper mass must be non-negative.'
            accel_scale = mover_mass / (mover_mass + bumper_mass)
    else:
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
# plane layout (kernels F and G: 9 state planes; kernel H: 8M + 1)
# ---------------------------------------------------------------------------


def _a_state(config: PlanningConfig, state: PlanningState) -> torch.Tensor:
    """The kernels' control-space acceleration ``[B, M, 2]``: the integrator
    activation in jerk mode, the last applied acceleration in acc mode."""
    return state.act if config.learn_jerk else state.acc


def state_to_planes(config: PlanningConfig, state: PlanningState) -> torch.Tensor:
    """The ``8M + 1`` f32 state planes in the kernels' order: positions,
    velocities, accelerations and goals (``2M`` each, mover-major then x/y),
    then the step counter."""
    b = state.pos.shape[0]
    blocks = [x.to(torch.float32).reshape(b, -1).T for x in (state.pos, state.vel, _a_state(config, state),
                                                            state.goals)]
    return torch.cat(blocks + [state.steps.to(torch.float32)[None]]).contiguous()


def _pair(planes: torch.Tensor, i: int) -> torch.Tensor:
    return torch.stack([planes[i], planes[i + 1]], dim=-1)


def _block(planes: torch.Tensor, i0: int, m: int) -> torch.Tensor:
    """``2M`` planes from ``i0`` as ``[B, M, 2]``."""
    return planes[i0:i0 + 2 * m].T.reshape(-1, m, 2)


def planes_to_state(config: PlanningConfig, planes: torch.Tensor, accel_scale) -> PlanningState:
    """The state from ``8M + 1`` kernel planes: qacc = accel_scale * act
    (``accel_scale`` a float or one per mover); ``act`` is the integrator
    state in jerk mode and zero in acc mode."""
    m = config.num_movers
    act = _block(planes, 4 * m, m)
    # a Python float multiplies as is: a tensor made from it on the card
    # would cost a blocking host-to-device copy in every step
    scale = accel_scale if isinstance(accel_scale, float) else accel_scale.reshape(-1, 1)
    return PlanningState(
        pos=_block(planes, 0, m), vel=_block(planes, 2 * m, m), acc=act * scale,
        act=act if config.learn_jerk else torch.zeros_like(act),
        goals=_block(planes, 6 * m, m), steps=planes[8 * m].to(torch.int32),
    )


# ---------------------------------------------------------------------------
# observations, info, reward
# ---------------------------------------------------------------------------


def _norm2(d: torch.Tensor) -> torch.Tensor:
    return sqrt((d * d).sum(-1))


def _obs_vec(config: PlanningConfig, vel: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``[B, 2M]`` velocities, or ``[B, 4M]`` velocities of all movers then
    their accelerations in jerk mode, from ``[B, M, 2]`` (or ``[B, 2]``)."""
    b = vel.shape[0]
    return torch.cat([vel, acc], dim=1).reshape(b, -1) if config.learn_jerk else vel.reshape(b, -1)


def _get_obs(config: PlanningConfig, params: PlanningParams, state: PlanningState, generator=None,
             normals=None) -> dict:
    """Noisy velocities (+ accelerations in jerk mode), noisy positions as
    the achieved goal.  ``normals`` ``[4M, B]`` (M position pairs, then M
    velocity pairs) or kernel A's."""
    b, m = state.pos.shape[0], config.num_movers
    n = noise_probe(2 * m, b, state.pos.device, generator=generator) if normals is None else normals
    pos_noisy = state.pos + n[:2 * m].T.reshape(b, m, 2) * params.std_noise[0]
    vel_noisy = state.vel + n[2 * m:].T.reshape(b, m, 2) * params.std_noise[1]
    return {
        'observation': _obs_vec(config, vel_noisy, state.acc),
        'achieved_goal': pos_noisy.reshape(b, 2 * m),
        'desired_goal': state.goals.reshape(b, 2 * m),
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


def _pose_noise_dims(config: PlanningConfig) -> int:
    return 6 if config.collision_shape == 'box' else 2


def _apply_pose_noise(config: PlanningConfig, pos: torch.Tensor, noise: torch.Tensor):
    """(noisy xy, noisy quaternion or None) from a scaled pose-noise block
    ``[..., M, 2]`` or ``[..., M, 6]`` (box: position, then quaternion
    around the identity)."""
    xy = pos + noise[..., :2]
    if config.collision_shape != 'box':
        return xy, None
    return xy, common.identity_quats((), pos.dtype, pos.device) + noise[..., 2:]


def _collision_checks(config: PlanningConfig, params: PlanningParams, pos: torch.Tensor, wall_noise: torch.Tensor,
                      mover_noise: torch.Tensor | None, wall_safety_offset: bool, mover_safety_offset: bool):
    """(wall_collision, mover_collision) ``[B]`` of ``pos`` ``[B, M, 2]``,
    each check on its own scaled pose noise: the wall by the dense rule
    with size c + offset_wall (+ offset), the movers with size c (+ offset).
    ``mover_noise`` may be None for one mover, who collides with nobody."""
    xy_w, quat_w = _apply_pose_noise(config, pos, wall_noise)
    c_wall = params.c_size + params.c_offset_wall
    if wall_safety_offset:
        c_wall = c_wall + params.c_offset
    wall = common.wall_collision_any(params.grid, xy_w, quat_w, c_wall, config.collision_shape)
    if config.num_movers == 1:
        return wall, torch.zeros_like(wall)
    xy_m, quat_m = _apply_pose_noise(config, pos, mover_noise)
    c_mover = params.c_size + params.c_offset if mover_safety_offset else params.c_size
    return wall, common.mover_collision_any(xy_m, quat_m, c_mover, config.collision_shape)


def _noisy_collision_checks(config: PlanningConfig, params: PlanningParams, pos: torch.Tensor,
                            wall_safety_offset: bool, mover_safety_offset: bool, generator=None):
    """``_collision_checks`` on pose noise from kernel A: for the wall
    check, and with more than one mover for the pair check."""
    b, m = pos.shape[0], config.num_movers
    p = _pose_noise_dims(config) // 2
    checks = 2 if m > 1 else 1
    n = noise_probe(checks * m * p, b, pos.device, generator=generator) * params.std_noise[0]
    n = n.reshape(checks, m, 2 * p, b).permute(0, 3, 1, 2)  # [checks, B, M, 2p]
    return _collision_checks(config, params, pos, n[0], n[1] if m > 1 else None, wall_safety_offset,
                             mover_safety_offset)


def _first_accepted(cands: torch.Tensor, accepts: torch.Tensor, block: int):
    """First accepted of K candidate sets ``[K, B, M, 2]`` (the last one
    where none is): (sample [B, M, 2], accepted [B], trials [B] int32), as
    the JAX package's bounded rejection sampler returns them when it draws
    ``block`` sets per round: trials count whole rounds, K on a stall."""
    k, b = accepts.shape
    ok = accepts.any(0)
    idx = torch.where(ok, torch.argmax(accepts.to(torch.int32), dim=0), k - 1)
    sample = cands.gather(0, idx[None, :, None, None].expand(1, b, *cands.shape[2:]))[0]
    return sample, ok, torch.where(ok, block * ((idx + block) // block), k).to(torch.int32)


def reset(config: PlanningConfig, params: PlanningParams, batch: int, generator: torch.Generator | None = None,
          start_xy=None, goals_xy=None):
    """Reset ``batch`` envs.  Starts: the first of ``max_reset_trials``
    uniform sets of M positions over ``[min_xy, max_xy]`` with every mover
    wall-valid by the dense rule (``ops/walls``; identity orientation, size
    c + offset + offset_wall) and no
    pair colliding (size c + offset; boxes by the 16-segment test); goals:
    wall-valid and pairwise at least ``min_goal_dist`` apart.  Then the noisy
    re-check of the starts (wall with the safety offset, movers without) and
    the first observation.  ``start_xy`` / ``goals_xy`` (``[M, 2]`` or
    ``[B, M, 2]``; for one mover also ``[2]`` or ``[B, 2]``) override the
    sampling.

    With M > 1 the JAX package draws 8 sets per round: the first accepted
    of all ``8 * ceil(max_reset_trials / 8)`` sets has the same
    distribution, and ``reset_trials`` counts whole rounds as it does.

    Returns ``(state, obs, info)`` with ``mover_collision`` and
    ``wall_collision`` from the noisy re-check, ``reset_stalled`` (no set
    accepted) and ``reset_trials`` (sets drawn; 0 where overridden) in
    ``info``."""
    m = config.num_movers
    device, dtype = params.min_xy.device, params.min_xy.dtype
    block = 8 if m > 1 else 1
    k = block * -(-config.max_reset_trials // block)
    c_sample = params.c_size + params.c_offset_wall + params.c_offset

    def walls_ok(xy):  # [..., M, 2] -> [...], identity orientation
        quat = common.identity_quats(xy.shape[:-1], dtype, device)
        return ~common.wall_collision_any(params.grid, xy, quat, c_sample, config.collision_shape)

    def accept_start(xy):
        quat = common.identity_quats(xy.shape[:-1], dtype, device)
        return walls_ok(xy) & ~common.mover_collision_any(xy, quat, params.c_size + params.c_offset,
                                                          config.collision_shape)

    def accept_goal(xy):
        ok = walls_ok(xy)
        if m > 1:
            ii, jj = collision.pair_tensors(m, device)
            d = xy[..., ii, :] - xy[..., jj, :]
            ok = ok & (sqrt((d * d).sum(-1)) >= params.min_goal_dist).all(-1)
        return ok

    def sample(accept):
        u = draw_uniforms(2 * m * k, batch, device, generator).to(dtype).reshape(k, m, 2, batch).permute(0, 3, 1, 2)
        lo, hi = params.min_xy, params.max_xy
        cands = torch.maximum(lo, u * (hi - lo) + lo)  # [k, B, M, 2]
        return _first_accepted(cands, accept(cands), block)

    def given(xy, accept):
        xy = torch.as_tensor(xy, dtype=dtype, device=device).reshape(-1, m, 2).expand(batch, m, 2)
        return xy, accept(xy), torch.zeros((batch,), dtype=torch.int32, device=device)

    start, start_ok, start_trials = sample(accept_start) if start_xy is None else given(start_xy, accept_start)
    goal, goal_ok, goal_trials = sample(accept_goal) if goals_xy is None else given(goals_xy, accept_goal)

    zeros = torch.zeros((batch, m, 2), dtype=dtype, device=device)
    state = PlanningState(pos=start.contiguous(), vel=zeros, acc=zeros.clone(), act=zeros.clone(),
                          goals=goal.contiguous(), steps=torch.zeros((batch,), dtype=torch.int32, device=device))

    # the starts re-checked with sensor noise: the wall with the safety
    # offset, the movers without
    wall, mover = _noisy_collision_checks(config, params, start, True, False, generator)
    obs = _get_obs(config, params, state, generator)
    info = _get_info(config, params, obs, mover, wall)
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
        for arr in (state.pos[:, 0], state.vel[:, 0], _a_state(config, state)[:, 0]):
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
    """Fused planning step + episode restart in one launch of kernel F (1
    mover) or kernel H (2 to 64 movers): cycles, termination, start/goal
    resampling with ``cand_k`` candidates (sets of M positions) each, both
    observations; sparse or dense reward from the pre-reset observation.  A
    stalled restart leaves the env un-reset and reports
    ``info['reset_stalled']`` (retried next step).  Same signature as
    ``make_fused_step``; with M movers ``action`` is ``[B, M, 2]`` or
    ``[B, 2M]``."""
    if config.num_movers > 1:
        return _make_multi_step_autoreset(config, params, cand_k)
    kc = kplan.make_kernel_consts(config, params, cand_k)
    limit, scale = _limit(config, params), _scale(params)

    def step_fn(state: PlanningState, action, noise=None, seed=None, generator=None):
        b = state.pos.shape[0]
        out = kplan.planning_autoreset(state_to_planes(config, state), _action_planes(action, b, limit), kc,
                                       uniforms=noise, seed=seed, generator=generator)
        new_state = planes_to_state(config, out, scale)
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
        obs = {'observation': _obs_vec(config, s_v, new_state.acc[:, 0]), 'achieved_goal': s_ag,
               'desired_goal': new_state.goals[:, 0]}
        truncated = (state.steps + 1) >= config.max_episode_steps
        return new_state, obs, reward, wall | reached, truncated, info

    step_fn.noise_planes = kplan.autoreset_noise_planes(config.num_cycles, cand_k, kc.box)
    return step_fn


def _make_multi_step_autoreset(config: PlanningConfig, params: PlanningParams, cand_k: int):
    """``make_fused_step_autoreset`` for M movers, on kernel H: shared-fate
    termination (any wall or mover collision, or all goals reached),
    ``is_success = all reached & not collided``, the sparse reward
    -(#unreached) between the +-50 events."""
    mc = kmulti.make_multi_kernel_consts(config, params, cand_k)
    m, limit = config.num_movers, _limit(config, params)
    scale = params.accel_scale.to(torch.float32).reshape(m, 1)

    def step_fn(state: PlanningState, action, noise=None, seed=None, generator=None):
        b = state.pos.shape[0]
        a = torch.clamp(action.to(torch.float32).reshape(b, 2 * m), -limit, limit).T.contiguous()
        out = kmulti.planning_multi_autoreset(state_to_planes(config, state), a, mc, uniforms=noise, seed=seed,
                                              generator=generator)
        new_state = planes_to_state(config, out, scale)
        s_v, s_ag = _block(out, 8 * m + 1, m), _block(out, 10 * m + 1, m)
        f_v, f_ag = _block(out, 12 * m + 1, m), _block(out, 14 * m + 1, m)
        f_acc = _block(out, 16 * m + 1, m) * scale  # pre-reset qacc from the act planes
        old_goals = state.goals.to(torch.float32)
        wall, mover = out[18 * m + 1] > 0.5, out[18 * m + 2] > 0.5
        unreached = out[18 * m + 3]
        collided = wall | mover
        all_reached = unreached == 0.0
        if config.reward_mode == 'dense':
            reward = torch.where(collided, -REWARD_SUCCESS, -_norm2(f_ag - old_goals).sum(-1))
        else:
            reward = torch.where(collided, -REWARD_SUCCESS, -unreached)
        reward = torch.where(all_reached & ~collided, REWARD_SUCCESS, reward)
        info = {
            'is_success': all_reached & ~collided,
            'mover_collision': mover,
            'wall_collision': wall,
            'final_observation': {'observation': _obs_vec(config, f_v, f_acc), 'achieved_goal': f_ag.reshape(b, -1),
                                  'desired_goal': old_goals.reshape(b, -1)},
            'reset_stalled': out[18 * m + 4] > 0.5,
            'reset_trials': out[18 * m + 5].to(torch.int32),
        }
        obs = {'observation': _obs_vec(config, s_v, new_state.acc), 'achieved_goal': s_ag.reshape(b, -1),
               'desired_goal': new_state.goals.reshape(b, -1)}
        truncated = (state.steps + 1) >= config.max_episode_steps
        return new_state, obs, reward, collided | all_reached, truncated, info

    step_fn.noise_planes = kmulti.multi_noise_planes(config.num_cycles, m, cand_k, mc.base.box)
    return step_fn


def _make_multi_rollout(config: PlanningConfig, params: PlanningParams, step_impl):
    """The M-mover rollout loop shared by ``make_fused_rollout`` and the
    card's plain-version timing: ``step_impl(planes [8M + 1, B], action
    [2M, B], seed) -> [18M + 6, B]`` (one autoreset step)."""
    m, limit = config.num_movers, _limit(config, params)
    scale = params.accel_scale.to(torch.float32).reshape(m, 1)
    max_steps = float(config.max_episode_steps)

    def rollout(state: PlanningState, actions, seed: int):
        b = state.pos.shape[0]
        actions = torch.clamp(actions.to(torch.float32).reshape(-1, b, 2 * m), -limit, limit)
        action_planes = actions.permute(0, 2, 1).contiguous()  # [T, 2M, B]
        planes = state_to_planes(config, state)
        rews, terms, truncs = [], [], []
        for t in range(action_planes.shape[0]):
            out = step_impl(planes, action_planes[t], seed + t)
            collided = torch.maximum(out[18 * m + 1], out[18 * m + 2]) > 0.5
            unreached = out[18 * m + 3]
            rews.append(torch.where(collided, -REWARD_SUCCESS,
                                    torch.where(unreached == 0.0, REWARD_SUCCESS, -unreached)))
            terms.append(collided | (unreached == 0.0))
            truncs.append(planes[8 * m] + 1.0 >= max_steps)
            planes = out[:8 * m + 1]
        return planes_to_state(config, planes, scale), torch.stack(rews), torch.stack(terms), torch.stack(truncs)

    return rollout


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
    """Plane-form rollout: the state stays in the kernels' ``[8M + 1, B]``
    plane layout across all steps, actions are given up front; sparse reward.

    One mover: ``steps_per_launch == 1`` launches kernel F once per step
    (seed ``seed + t``); ``steps_per_launch = K > 1`` launches kernel G over
    chunks of K steps plus one tail chunk (seed ``seed + chunk``).  M movers:
    kernel H once per step (seed ``seed + t``) whatever ``steps_per_launch``
    says, as in the JAX package, which has no K-step M-mover kernel.  On CPU
    tensors the plain versions draw their uniforms from a generator seeded
    the same way.

    Returns ``rollout(state, actions [T, B, M, 2], seed) -> (final state,
    rewards [T, B], terminated [T, B], truncated [T, B])``."""
    if config.reward_mode != 'sparse':
        raise ValueError("the fused rollout computes the sparse reward in-plane; reward_mode='dense' "
                         'runs on make_fused_step_autoreset')

    gen = common.seeded_generator
    if config.num_movers > 1:
        mc = kmulti.make_multi_kernel_consts(config, params, cand_k)
        return _make_multi_rollout(config, params, lambda planes, action, seed: kmulti.planning_multi_autoreset(
            planes, action, mc, seed=seed, generator=gen(planes, seed)))
    kc = kplan.make_kernel_consts(config, params, cand_k)

    def step_impl(planes, action, seed):
        return kplan.planning_autoreset(planes, action, kc, seed=seed, generator=gen(planes, seed))

    def chunk_impl(planes, actions, seed):
        return kplan.planning_rollout(planes, actions, kc, seed=seed, generator=gen(planes, seed))

    return _make_rollout(config, params, steps_per_launch, step_impl, chunk_impl)


def make_reactive_rollout(config: PlanningConfig, params: PlanningParams, policy_step, num_steps: int,
                          cand_k: int = 16, dense_reward: bool = False):
    """Plane-form rollout driven by a policy in the loop, one mover: the
    planning counterpart of ``pushing.make_reactive_rollout`` (see there for
    ``policy_step``, ``policy_xs``, the seeds and the noise-free first
    observation), one kernel F launch per step.

    The policy features are ``[vel, achieved, goal]`` ``[6, B]``, from F's
    post-reset observation planes (outputs 9-12) and the goal planes; the
    pre-reset ones (outputs 13-16 with the old goal) form ``final_vec``.
    ``reward`` is +50 on reaching, -50 on a wall hit, else -1, or the
    negative goal distance with ``dense_reward``; ``terminated`` is a wall
    hit or a reached goal.  Returns ``rollout(state, pol, generator, seed,
    policy_xs=None) -> (final state, (obs_vec [T, B, 6], aux, reward,
    terminated, truncated, final_vec [T, B, 6]), last_obs_vec [B, 6])``.
    One mover, acceleration mode and f32 only, as in the JAX package."""
    if config.num_movers != 1:
        raise ValueError(f'the reactive rollout covers 1 mover, got {config.num_movers}')
    if config.learn_jerk:
        raise ValueError('the reactive rollout runs in acc mode only')
    if params.v_max.dtype != torch.float32:
        raise ValueError('the reactive rollout runs in f32 only: the f64 parity mode has no fused kernel')
    kc = kplan.make_kernel_consts(config, params, cand_k)
    a_max, scale = float(params.a_max), _scale(params)
    max_steps = float(config.max_episode_steps)

    def rollout(state: PlanningState, pol, generator, seed: int, policy_xs=None):
        planes = state_to_planes(config, state)
        # first observation from the state planes (noise-free): vel, achieved
        obs = planes[[2, 3, 0, 1]]
        obs_vecs, auxs, outs, goals = [], [], [], []
        for t in range(num_steps):
            obs_vec = torch.cat([obs, planes[6:8]])
            action, aux = policy_step(pol, generator if policy_xs is None else policy_xs[t], obs_vec)
            action = torch.clamp(action.to(torch.float32), -a_max, a_max).contiguous()
            out = kplan.planning_autoreset(planes, action, kc, seed=seed + t,
                                           generator=common.seeded_generator(planes, seed + t))
            obs_vecs.append(obs_vec)
            auxs.append(aux)
            outs.append(out)
            goals.append(planes[6:9])  # the old goal and the step counter
            planes, obs = out[:9], out[9:13]
        # rewards and flags once per rollout over [T, B] (they do not feed
        # back into the loop): fewer launches per step on the card
        outs, goals = torch.stack(outs), torch.stack(goals)
        final_vec = torch.cat([outs[:, 13:17], goals[:, :2]], dim=1)  # [T, 6, B]
        wall, reached = outs[:, 19] > 0.5, outs[:, 20] > 0.5
        if dense_reward:
            ddx, ddy = outs[:, 15] - goals[:, 0], outs[:, 16] - goals[:, 1]
            miss = -sqrt(ddx * ddx + ddy * ddy)
        else:
            miss = -1.0
        reward = torch.where(wall, -REWARD_SUCCESS, torch.where(reached, REWARD_SUCCESS, miss))
        traj = (torch.stack(obs_vecs).transpose(1, 2), common.stack_batch_last(auxs), reward, wall | reached,
                goals[:, 2] + 1.0 >= max_steps, final_vec.transpose(1, 2))
        return planes_to_state(config, planes, scale), traj, torch.cat([obs, planes[6:8]]).T

    return rollout


# ---------------------------------------------------------------------------
# the eager step
# ---------------------------------------------------------------------------


def draw_step_noise(config: PlanningConfig, batch: int, dtype, device, generator=None) -> dict:
    """The standard normals one eager step consumes, from ``generator``:
    ``'vel'`` ``[C, B, M, 2]`` (velocity readings), ``'pose'`` ``[C, B, 2,
    M, P]`` (the wall check's and the pair check's poses; P = 6 for the box,
    else 2), ``'obs'`` ``[4M, B]`` (the observation; ``None`` here: kernel A
    draws them)."""
    c, m = config.num_cycles, config.num_movers
    return {'vel': common.normals((c, batch, m, 2), dtype, device, generator),
            'pose': common.normals((c, batch, 2, m, _pose_noise_dims(config)), dtype, device, generator),
            'obs': None}


def _step_core(config: PlanningConfig, params: PlanningParams, state: PlanningState, action, noise=None,
               generator=None):
    """One env step of every env: ``num_cycles`` 1 ms control cycles (clamp
    chain, integration, then the noisy wall and pair checks), each env
    frozen from the cycle a check fires, with its flags (the latched
    ``done``).  ``action`` ``[B, M, 2]`` or ``[B, 2M]``; ``noise`` the
    standard normals of ``draw_step_noise`` (drawn from ``generator`` when
    not given).  Returns ``((state, obs, reward, terminated, truncated,
    info), cycles)`` with the per-cycle ``(pos, vel, done)`` stacked ``[B,
    C, ...]``; terminated where ``|reward| == REWARD_SUCCESS``."""
    m = config.num_movers
    dtype, device = state.pos.dtype, state.pos.device
    b = state.pos.shape[0]
    limit = params.j_max if config.learn_jerk else params.a_max
    action = torch.clamp(action.to(dtype).reshape(b, m, 2), -limit, limit)
    if noise is None:
        noise = draw_step_noise(config, b, dtype, device, generator)
    vel_noise = noise['vel'] * params.std_noise[1]
    pose_noise = noise['pose'] * params.std_noise[0]
    scale = params.accel_scale[:, None]  # [M, 1] over the (x, y) pair

    pos, vel, acc, act = state.pos, state.vel, state.acc, state.act
    wall = torch.zeros((b,), dtype=torch.bool, device=device)
    mover = torch.zeros_like(wall)
    done = torch.zeros_like(wall)
    cycles = []
    for k in range(config.num_cycles):
        vel_meas = vel + vel_noise[k]
        if config.learn_jerk:
            res = dynamics.jerk_cycle(pos, vel, act, vel_meas, action, params.v_max, params.a_max, params.dt,
                                      accel_scale=scale)
        else:
            res = dynamics.acceleration_cycle(pos, vel, vel_meas, action, params.v_max, params.dt, accel_scale=scale)
        new_wall, new_mover = _collision_checks(config, params, res.pos, pose_noise[k][:, 0], pose_noise[k][:, 1],
                                                wall_safety_offset=False, mover_safety_offset=False)
        # once done, the state freezes and the flags keep their value at the
        # colliding cycle
        d3 = done[:, None, None]
        pos = torch.where(d3, pos, res.pos)
        vel = torch.where(d3, vel, res.vel)
        acc = torch.where(d3, acc, res.acc)
        act = torch.where(d3, act, res.act)
        wall = torch.where(done, wall, new_wall)
        mover = torch.where(done, mover, new_mover)
        done = done | wall | mover
        cycles.append((pos, vel, done))

    new_state = PlanningState(pos=pos, vel=vel, acc=acc, act=act, goals=state.goals, steps=state.steps + 1)
    obs = _get_obs(config, params, new_state, generator, noise['obs'])
    info = _get_info(config, params, obs, mover, wall)
    reward = compute_reward(config, params, obs['achieved_goal'], obs['desired_goal'], mover, wall)
    stacked = tuple(torch.stack(leaf, dim=1) for leaf in zip(*cycles))
    return (new_state, obs, reward, reward.abs() == REWARD_SUCCESS, torch.zeros_like(wall), info), stacked


def step(config: PlanningConfig, params: PlanningParams, state: PlanningState, action, noise=None, generator=None):
    """One eager env step of every env (see ``_step_core``): ``(state, obs,
    reward, terminated, truncated, info)``."""
    return _step_core(config, params, state, action, noise, generator)[0]


def step_with_cycles(config: PlanningConfig, params: PlanningParams, state: PlanningState, action, noise=None,
                     generator=None):
    """``step`` plus the per-cycle ``(pos [B, C, M, 2], vel [B, C, M, 2],
    done [B, C])`` for a per-cycle replay; ``done`` stops it at the
    colliding cycle."""
    out, cyc = _step_core(config, params, state, action, noise, generator)
    return (*out, cyc)


def step_autoreset(config: PlanningConfig, params: PlanningParams, state: PlanningState, action, noise=None,
                   generator=None):
    """``step`` with the restart of every env that terminated or reached the
    time limit: the pre-reset observation goes to
    ``info['final_observation']``, ``obs`` is the new episode's first; an env
    whose start or goal sampling stalled stays un-reset
    (``info['reset_stalled']``) and retries on the next step.  The restarts
    are drawn from ``generator``."""
    new_state, obs, reward, terminated, _, info = step(config, params, state, action, noise, generator)
    truncated = new_state.steps >= config.max_episode_steps
    done = terminated | truncated
    reset_state, reset_obs, reset_info = reset(config, params, state.pos.shape[0], generator)
    do_reset = done & ~reset_info['reset_stalled']
    kept = autoreset_select(do_reset, new_state, reset_state)
    out_obs = {k: _where_done(do_reset, reset_obs[k], v) for k, v in obs.items()}
    info = dict(info, final_observation=obs, reset_stalled=done & reset_info['reset_stalled'],
                reset_trials=torch.where(done, reset_info['reset_trials'], 0))
    return kept, out_obs, reward, terminated, truncated, info


batched_step = step
batched_step_autoreset = step_autoreset
