"""BenchmarkPushingEnv in PyTorch: one mover pushes a box to a goal.

Counterpart of ``gymnasium_planar_robotics_tpu/models/pushing.py``:
``make_pushing_env``, ``reset`` / ``init_batch``, the eager step (``step``,
``step_with_cycles``, ``step_autoreset``; 40 control cycles of torch ops
with the contact of ``ops/contact``, the XLA path of the JAX package), the
per-step fused APIs ``make_fused_step`` and ``make_fused_step_autoreset``,
the plane-form rollout ``make_fused_rollout`` and the policy-in-the-loop
``make_reactive_rollout`` (PPO's training rollout).  The fused paths run
the CUDA kernels of ``ops/kernels/pushing`` on CUDA tensors and their plain
PyTorch versions on CPU tensors.

Differences from the JAX package, by design:

- ``PushingState`` has no ``key``: eager functions take a ``generator=``
  (a ``torch.Generator`` on the state's device) and, for parity tests,
  pre-drawn standard normals (``noise=``), kernels take an integer seed and
  draw from a Philox stream inside the kernel;
- every function is batched: the state carries the batch as its leading
  axis, so ``batched_step`` is ``step``;
- the configuration covers the fixed 3x3 table with the circle or box
  collision shape and box, cylinder or mesh movers (the predefined meshes
  are generated into the port's own ``assets/``, ``utils/meshes``);
- any batch size runs without padding (the kernels mask the tail block);
- ``make_pushing_env`` and the numpy converters put their tensors on the
  card unless the caller passes ``device='cpu'`` (no fallback without a GPU).

Public layouts follow the JAX package: ``[B, 2]`` pairs, ``[B]`` scalars,
``[T, B]`` rollout outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.ops import contact, dynamics, walls
from gymnasium_planar_robotics_tpu_torch.ops.grid import TileGrid, make_tile_grid
from gymnasium_planar_robotics_tpu_torch.ops.kernels import draw_uniforms
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import noise_probe
from gymnasium_planar_robotics_tpu_torch.utils import meshes, profiling

REWARD_WALL_COLLISION = -50.0


@dataclasses.dataclass(frozen=True)
class PushingConfig:
    num_cycles: int = 40
    learn_jerk: bool = False
    collision_shape: str = 'circle'
    max_reset_trials: int = 100
    max_episode_steps: int = 50
    num_movers: int = 1
    reward_mode: str = 'sparse'


@dataclasses.dataclass(frozen=True)
class PushingParams:
    grid: TileGrid
    mover_mass: torch.Tensor
    accel_scale: torch.Tensor
    total_mass: torch.Tensor
    mover_half: torch.Tensor  # [2]
    c_size: torch.Tensor  # [1]
    c_offset: torch.Tensor
    c_offset_wall: torch.Tensor
    std_noise: torch.Tensor  # [3]
    object_half: torch.Tensor  # [2]
    object_mass: torch.Tensor
    object_damping: torch.Tensor
    object_noise: torch.Tensor
    v_max: torch.Tensor
    a_max: torch.Tensor
    j_max: torch.Tensor
    threshold_pos: torch.Tensor
    initial_zpos: torch.Tensor
    dt: torch.Tensor
    min_xy: torch.Tensor  # [2] mover sampling bounds
    max_xy: torch.Tensor
    obj_min_xy: torch.Tensor  # [2] object/goal sampling bounds
    obj_max_xy: torch.Tensor
    min_mo_dist: torch.Tensor
    contact_k: torch.Tensor
    contact_b: torch.Tensor
    contact_bt: torch.Tensor
    contact_mu: torch.Tensor
    floor_mu: torch.Tensor
    gravity: torch.Tensor
    obj_inertia: torch.Tensor
    mu_spin: torch.Tensor
    plow_kappa: torch.Tensor
    plow_cap: torch.Tensor
    cone_zeta: torch.Tensor
    cone_vt: torch.Tensor
    cone_vt_hi: torch.Tensor
    cone_vt_off: torch.Tensor
    cone_plow: torch.Tensor
    cone_plow_cap: torch.Tensor
    mover_height: torch.Tensor
    object_height: torch.Tensor
    imp_k: torch.Tensor
    imp_d: torch.Tensor
    cone_fz_cap: torch.Tensor
    cone_fz_slope: torch.Tensor


@dataclasses.dataclass
class PushingState:
    pos: torch.Tensor  # [B, 2] mover position
    vel: torch.Tensor  # [B, 2]
    acc: torch.Tensor  # [B, 2] last qacc (incl. contact reaction)
    act: torch.Tensor  # [B, 2] jerk-integrator activation
    obj_pos: torch.Tensor  # [B, 2]
    obj_vel: torch.Tensor  # [B, 2]
    obj_yaw: torch.Tensor  # [B]
    obj_w: torch.Tensor  # [B]
    mover_z: torch.Tensor  # [B] mover bottom height above the tile top
    mover_vz: torch.Tensor  # [B]
    goal: torch.Tensor  # [B, 2] object goal
    steps: torch.Tensor  # [B] int32


def make_pushing_env(
    mover_params: dict[str, Any] | None = None,
    initial_mover_zpos: float = 0.003,
    std_noise=1e-5,
    num_cycles: int = 40,
    collision_params: dict[str, Any] | None = None,
    v_max: float = 2.0,
    a_max: float = 10.0,
    j_max: float = 100.0,
    learn_jerk: bool = False,
    threshold_pos: float = 0.05,
    dtype=torch.float32,
    max_reset_trials: int = 100,
    reward_mode: str = 'sparse',
    device=None,
) -> tuple[PushingConfig, PushingParams]:
    """Constructor with the JAX package's kwargs and constants (fixed 3x3
    layout, 1 mover).  Bounds are formed in float64 NumPy and then cast.
    The tensors go to ``device``: the card unless the caller names another."""
    device = common.resolve_device(device)
    mover_params = mover_params or {}
    collision_params = collision_params or {}
    unsupported = set(mover_params) - {'mass', 'size', 'shape', 'mesh'}
    if unsupported:
        raise ValueError(
            f'unsupported mover_params keys for the pushing env: {sorted(unsupported)} '
            "(supported: 'mass', 'size', 'shape', 'mesh')"
        )
    c_shape = collision_params.get('shape', 'circle')
    if c_shape not in ('circle', 'box'):
        raise ValueError(f'unknown collision shape {c_shape!r}')
    if reward_mode not in ('sparse', 'dense'):
        raise ValueError(f'unknown reward_mode {reward_mode!r}')

    layout = np.ones((3, 3))
    tile_size = np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2])
    grid = make_tile_grid(layout, tile_size, dtype=dtype, device=device)

    mover_mass = float(np.asarray(mover_params.get('mass', 1.24)).reshape(-1)[0])
    mover_shape = mover_params.get('shape', 'box')
    bumper_mass = 0.0
    if mover_shape == 'mesh':
        # size from the (scaled) mesh AABB; a bumper's mass joins the body
        # while the actuator gain stays the configured mover mass
        mesh_cfg = mover_params.get('mesh', {})
        mover_size = np.asarray(meshes.resolve_mover_size(
            'mesh', None, mesh_cfg.get('mover_stl_path', 'beckhoff_apm4330_mover'),
            mesh_cfg.get('scale', (1.0, 1.0, 1.0)))).reshape(-1)
        if mesh_cfg.get('bumper_stl_path', 'beckhoff_apm4330_bumper') is not None:
            bumper_mass = float(np.asarray(mesh_cfg.get('bumper_mass', 0.1)).reshape(-1)[0])
            if bumper_mass < 0:
                raise ValueError('Bumper mass must be non-negative.')
    elif mover_shape in ('box', 'cylinder'):
        mover_size = np.asarray(mover_params.get('size', np.array([0.155 / 2, 0.155 / 2, 0.012 / 2]))).reshape(-1)
    else:
        raise ValueError(f'unknown mover shape {mover_shape!r}')
    total_mass = mover_mass + bumper_mass
    accel_scale = mover_mass / total_mass

    c_size_in = collision_params.get('size', 0.11)
    c_offset = float(collision_params.get('offset', 0.0))
    c_offset_wall = float(collision_params.get('offset_wall', 0.0))
    c_size = common.expand_c_size(c_size_in, 1, c_shape, dtype, device)

    std = np.asarray(std_noise, dtype=np.float64).reshape(-1)
    std = np.broadcast_to(std, (3,)) if std.shape == (1,) else std

    object_half = 0.07 / 2
    mover_reach = float(np.linalg.norm(object_half + mover_size[:2]))
    if c_shape == 'circle':
        margin = np.asarray(c_size_in).reshape(-1)[0] + c_offset + c_offset_wall
        margin = np.array([margin, margin])
        min_mo = max(mover_reach, float(np.asarray(c_size_in).reshape(-1)[0] + c_offset))
    else:
        margin = np.asarray(c_size_in).reshape(-1, 2)[0] + c_offset + c_offset_wall
        min_mo = max(mover_reach, float(np.linalg.norm(np.asarray(c_size_in).reshape(-1, 2)[0] + c_offset)))
    # the workspace bound: max tile center + tile_size/2 = 0.66 on the 3x3 table
    hi = np.array([5 * tile_size[0] + tile_size[0] / 2, 5 * tile_size[1] + tile_size[1] / 2])

    config = PushingConfig(
        num_cycles=num_cycles,
        learn_jerk=learn_jerk,
        collision_shape=c_shape,
        max_reset_trials=max_reset_trials,
        reward_mode=reward_mode,
    )

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)

    obj_mass = 0.01
    k_n = 30.0
    params = PushingParams(
        grid=grid,
        mover_mass=t(mover_mass),
        accel_scale=t(accel_scale),
        total_mass=t(total_mass),
        mover_half=t(mover_size[:2]),
        c_size=c_size,
        c_offset=t(c_offset),
        c_offset_wall=t(c_offset_wall),
        std_noise=t(std),
        object_half=t([object_half, object_half]),
        object_mass=t(obj_mass),
        object_damping=t(0.01),
        object_noise=t(1e-5),
        v_max=t(v_max),
        a_max=t(a_max),
        j_max=t(j_max),
        threshold_pos=t(threshold_pos),
        initial_zpos=t(initial_mover_zpos),
        dt=t(0.001),
        min_xy=t(margin),
        max_xy=t(hi - margin),
        obj_min_xy=t(2 * margin),
        obj_max_xy=t(hi - 2 * margin),
        min_mo_dist=t(min_mo),
        contact_k=t(k_n),
        contact_b=t(2.0 * np.sqrt(k_n * obj_mass)),
        contact_bt=t(1.0),
        contact_mu=t(0.8),
        floor_mu=t(1.0),
        gravity=t(9.81),
        obj_inertia=t(obj_mass * (object_half**2 + object_half**2) / 3.0),
        mu_spin=t(60.0),
        plow_kappa=t(4.0),
        plow_cap=t(1.5),
        cone_zeta=t(0.8),
        cone_vt=t(0.25),
        cone_vt_hi=t(0.4),
        cone_vt_off=t(0.7),
        cone_plow=t(1.0),
        cone_plow_cap=t(8.0),
        mover_height=t(2.0 * mover_size[2]),
        object_height=t(0.04),
        imp_k=t(1.0),
        imp_d=t(2.0 * np.sqrt(1.0 * mover_mass)),
        cone_fz_cap=t(0.008),
        cone_fz_slope=t(100.0),
    )
    return config, params


# ---------------------------------------------------------------------------
# numpy converters (the JAX package's leaves as numpy arrays <-> tensors)
# ---------------------------------------------------------------------------


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def params_to_numpy(params: PushingParams) -> dict:
    """Every leaf as a numpy array; ``'grid'`` is a dict of the grid's leaves."""
    out = {f.name: _to_numpy(getattr(params, f.name)) for f in dataclasses.fields(params) if f.name != 'grid'}
    out['grid'] = {f.name: _to_numpy(getattr(params.grid, f.name)) for f in dataclasses.fields(params.grid)}
    return out


def params_from_numpy(d: dict, device=None) -> PushingParams:
    """Build the port's params from numpy leaves (e.g. the JAX package's
    ``PushingParams`` leaves through ``np.asarray``), on ``device`` (the
    card unless named)."""
    device = common.resolve_device(device)
    grid = TileGrid(**{f.name: torch.as_tensor(np.array(d['grid'][f.name]), device=device)
                       for f in dataclasses.fields(TileGrid)})
    leaves = {f.name: torch.as_tensor(np.array(d[f.name]), device=device)
              for f in dataclasses.fields(PushingParams) if f.name != 'grid'}
    return PushingParams(grid=grid, **leaves)


def state_to_numpy(state: PushingState) -> dict:
    return {f.name: _to_numpy(getattr(state, f.name)) for f in dataclasses.fields(state)}


def state_from_numpy(d: dict, device=None) -> PushingState:
    """Build a port state from numpy leaves on ``device`` (the card unless
    named); a JAX ``key`` leaf is dropped."""
    device = common.resolve_device(device)
    return PushingState(**{f.name: torch.as_tensor(np.array(d[f.name]), device=device)
                           for f in dataclasses.fields(PushingState)})


# ---------------------------------------------------------------------------
# plane layout
# ---------------------------------------------------------------------------


def state_to_planes(state: PushingState) -> torch.Tensor:
    """The 19 f32 state planes ``[19, B]`` in the kernels' order."""
    cols = []
    for arr in (state.pos, state.vel, state.acc, state.act, state.obj_pos, state.obj_vel):
        cols += [arr[:, 0], arr[:, 1]]
    cols += [state.obj_yaw, state.obj_w, state.mover_z, state.mover_vz, state.goal[:, 0], state.goal[:, 1],
             state.steps]
    return torch.stack([c.to(torch.float32) for c in cols])


def _pair(planes: torch.Tensor, i: int) -> torch.Tensor:
    return torch.stack([planes[i], planes[i + 1]], dim=-1)


def planes_to_state(planes: torch.Tensor) -> PushingState:
    return PushingState(
        pos=_pair(planes, 0), vel=_pair(planes, 2), acc=_pair(planes, 4), act=_pair(planes, 6),
        obj_pos=_pair(planes, 8), obj_vel=_pair(planes, 10), obj_yaw=planes[12].clone(), obj_w=planes[13].clone(),
        mover_z=planes[14].clone(), mover_vz=planes[15].clone(), goal=_pair(planes, 16),
        steps=planes[18].to(torch.int32),
    )


# ---------------------------------------------------------------------------
# reset, observations, reward
# ---------------------------------------------------------------------------


def _obs_dict(config, pos, vel, acc, achieved, goal):
    parts = [pos, vel] + ([acc] if config.learn_jerk else [])
    return {'observation': torch.cat(parts, dim=-1), 'achieved_goal': achieved, 'desired_goal': goal}


def _get_obs(config: PushingConfig, params: PushingParams, state: PushingState, generator=None, normals=None):
    """Noisy observation (pos, vel (, acc)), noisy achieved goal, goal.
    ``normals`` ``[6, B]`` (pos, vel and object pairs) or kernel A's."""
    b = state.pos.shape[0]
    n = noise_probe(3, b, state.pos.device, generator=generator) if normals is None else normals
    std = params.std_noise
    pos = state.pos + n[0:2].T * std[0]
    vel = state.vel + n[2:4].T * std[1]
    achieved = state.obj_pos + n[4:6].T * params.object_noise
    return _obs_dict(config, pos, vel, state.acc, achieved, state.goal)


def _get_info(params: PushingParams, obs, wall_collision):
    dist = torch.linalg.vector_norm(obs['achieved_goal'] - obs['desired_goal'], dim=-1)
    return {
        'is_success': (dist <= params.threshold_pos) & ~wall_collision,
        'mover_collision': torch.zeros_like(wall_collision),
        'wall_collision': wall_collision,
    }


def compute_reward(params: PushingParams, achieved_goal, desired_goal, wall_collision):
    """Batched sparse reward: 0 at the goal, -1 per step, -50 on a mover
    wall collision."""
    dist = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
    reached = dist <= params.threshold_pos
    reward = torch.where(wall_collision, REWARD_WALL_COLLISION, -1.0)
    return torch.where(reached & ~wall_collision, 0.0, reward).to(achieved_goal.dtype)


def reset(
    config: PushingConfig,
    params: PushingParams,
    batch: int,
    generator: torch.Generator | None = None,
    mover_start_xy_pos=None,
    object_goal_xy_pos=None,
    noise=None,
):
    """Reset ``batch`` envs: mover uniform over the table, object = the first
    accepted of ``max_reset_trials`` uniform draws over the inner box that
    lies farther than ``min_mo_dist`` from the mover, goal uniform over the
    inner box.  Returns ``(state, obs, info)`` with ``reset_stalled`` (no
    draw accepted) and ``reset_trials`` in ``info``.

    ``noise`` (parity tests): the standard normals of the start's wall check
    and of the first observation, ``{'pose': [B, P], 'obs': [6, B]}`` with
    P = 2 (circle: xy) or 6 (box: xy, then the quaternion's four
    components around the identity); drawn with kernel A when not given."""
    device, dtype = params.min_xy.device, params.min_xy.dtype
    k = config.max_reset_trials
    u = draw_uniforms(2 + 2 * k + 2, batch, device, generator)

    def uniform_in(uu, lo, hi):  # uu: [..., 2, B] -> [..., B, 2]
        return lo + uu.transpose(-1, -2) * (hi - lo)

    if mover_start_xy_pos is None:
        mover_xy = uniform_in(u[0:2], params.min_xy, params.max_xy)
    else:
        mover_xy = torch.as_tensor(mover_start_xy_pos, dtype=dtype, device=device).reshape(-1, 2).expand(batch, 2)

    cands = uniform_in(u[2 : 2 + 2 * k].reshape(k, 2, batch), params.obj_min_xy, params.obj_max_xy)  # [k, B, 2]
    accepts = torch.linalg.vector_norm(cands - mover_xy[None], dim=-1) > params.min_mo_dist  # [k, B]
    idx = torch.argmax(accepts.to(torch.int32), dim=0)
    obj_xy = cands.gather(0, idx[None, :, None].expand(1, batch, 2))[0]
    obj_ok = accepts.any(dim=0)
    trials = torch.where(obj_ok, idx + 1, k).to(torch.int32)

    if object_goal_xy_pos is None:
        goal = uniform_in(u[2 + 2 * k :], params.obj_min_xy, params.obj_max_xy)
    else:
        goal = torch.as_tensor(object_goal_xy_pos, dtype=dtype, device=device).reshape(-1, 2).expand(batch, 2)

    zeros2 = torch.zeros((batch, 2), dtype=dtype, device=device)
    zeros = torch.zeros((batch,), dtype=dtype, device=device)
    state = PushingState(
        pos=mover_xy.contiguous(), vel=zeros2, acc=zeros2.clone(), act=zeros2.clone(),
        obj_pos=obj_xy, obj_vel=zeros2.clone(), obj_yaw=zeros, obj_w=zeros.clone(),
        mover_z=params.initial_zpos.expand(batch).clone(), mover_vz=zeros.clone(), goal=goal.contiguous(),
        steps=torch.zeros((batch,), dtype=torch.int32, device=device),
    )
    # wall check of the noisy start pose with the reset-time size
    # (c + offset_wall + offset), by the dense rule
    if noise is None:
        noise = {'pose': noise_probe(_pose_noise_dims(config) // 2, batch, device, generator=generator).T,
                 'obs': None}
    wall = _wall_collision_with_noise(config, params, mover_xy, noise['pose'] * params.std_noise[0],
                                      with_offset=True)
    obs = _get_obs(config, params, state, generator, noise['obs'])
    info = _get_info(params, obs, wall)
    info['reset_stalled'] = ~obj_ok
    info['reset_trials'] = trials
    return state, obs, info


def init_batch(config: PushingConfig, params: PushingParams, batch: int, generator: torch.Generator | None = None):
    """Reset ``batch`` independent pushing envs (see ``reset``)."""
    return reset(config, params, batch, generator)


def _pose_noise_dims(config: PushingConfig) -> int:
    return 6 if config.collision_shape == 'box' else 2


def _wall_collision_with_noise(config: PushingConfig, params: PushingParams, pos: torch.Tensor, noise: torch.Tensor,
                               with_offset: bool):
    """The mover's wall check at ``pos`` under the scaled pose noise
    ``noise`` ``[B, P]`` (xy; for the box also the quaternion's four
    components around the identity), size c + offset_wall (+ offset), dense
    rule."""
    c = params.c_size + params.c_offset_wall
    if with_offset:
        c = c + params.c_offset
    quat = None
    if config.collision_shape == 'box':
        quat = common.identity_quats((), pos.dtype, pos.device) + noise[:, 2:]
    return ~walls.qpos_is_valid(params.grid, pos + noise[:, :2], c, quat=quat, collision_shape=config.collision_shape)


# ---------------------------------------------------------------------------
# the eager step
# ---------------------------------------------------------------------------


def draw_step_noise(config: PushingConfig, batch: int, dtype, device, generator=None) -> dict:
    """The standard normals one eager step consumes, from ``generator``:
    ``'vel'`` ``[C, B, 2]`` (velocity readings), ``'pose'`` ``[C, B, P]``
    (the wall check's pose: xy, for the box also the quaternion's four
    components), ``'obs'`` ``[6, B]`` (the observation's pos, vel and object
    pairs; ``None`` here: kernel A draws them)."""
    c = config.num_cycles
    return {'vel': common.normals((c, batch, 2), dtype, device, generator),
            'pose': common.normals((c, batch, _pose_noise_dims(config)), dtype, device, generator), 'obs': None}


def _step_core(config: PushingConfig, params: PushingParams, state: PushingState, action, noise=None,
               generator=None):
    """One env step of every env: ``num_cycles`` control cycles of (clamp
    chain -> contact -> integrate -> noisy wall check), each env frozen from
    the cycle its wall check fires (the latched ``done``).  ``noise``: the
    standard normals of ``draw_step_noise`` (drawn from ``generator`` when
    not given).  Returns ``((state, obs, reward, terminated, truncated,
    info), cycles)`` with the per-cycle ``(pos, vel, obj_pos, obj_yaw,
    done)`` stacked ``[B, C, ...]``."""
    dtype, device = state.pos.dtype, state.pos.device
    b = state.pos.shape[0]
    limit = params.j_max if config.learn_jerk else params.a_max
    action = torch.clamp(action.to(dtype).reshape(b, 2), -limit, limit)
    if noise is None:
        noise = draw_step_noise(config, b, dtype, device, generator)
    vel_noise = noise['vel'] * params.std_noise[1]
    pose_noise = noise['pose'] * params.std_noise[0]
    dt = params.dt
    mu_g_dt = params.floor_mu * params.gravity * dt
    mg = params.object_mass * params.gravity

    pos, vel, acc, act = state.pos, state.vel, state.acc, state.act
    obj_pos, obj_vel, obj_yaw, obj_w = state.obj_pos, state.obj_vel, state.obj_yaw, state.obj_w
    mz, mvz = state.mover_z, state.mover_vz
    c_axis = torch.full((b,), -1.0, dtype=dtype, device=device)
    wall = torch.zeros((b,), dtype=torch.bool, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    cycles = []
    for k in range(config.num_cycles):
        vel_meas = vel + vel_noise[k]
        # clamp chain -> the actuator's commanded acceleration (jerk mode
        # measures the full qacc, contact included)
        if config.learn_jerk:
            acc_tmp, jerk_1 = dynamics.ensure_max_dyn_val(acc, params.a_max, action, dt)
            _, acc_final = dynamics.ensure_max_dyn_val(vel_meas, params.v_max, acc_tmp, dt)
            clamped = (acc_final != acc_tmp).any(-1, keepdim=True)
            jerk_ctrl = torch.where(clamped, (acc_final - acc) / dt, jerk_1)
            new_act = act + dt * jerk_ctrl
            ctrl_acc = new_act
        else:
            _, ctrl_acc = dynamics.ensure_max_dyn_val(vel_meas, params.v_max, action, dt)
            new_act = act

        # contact from the pre-integration state; the wedge cap grows with
        # the mover's accumulated lift
        forces = contact.box_push_contact_v2(
            pos, vel, obj_pos, obj_vel, obj_yaw, obj_w, params.mover_half, params.object_half,
            params.contact_k, params.contact_b, params.contact_bt, params.contact_mu,
            sticky_axis=c_axis, cone_zeta=params.cone_zeta, cone_vt=params.cone_vt, cone_vt_hi=params.cone_vt_hi,
            cone_vt_off=params.cone_vt_off,
            fz_cap=params.cone_fz_cap + params.cone_fz_slope * torch.clamp(mz - params.initial_zpos, min=0.0),
        )
        # quasi-3D: the contact acts over the z-overlap of the mover's side
        # face with the object
        zf = torch.clamp((torch.minimum(mz + params.mover_height, params.object_height) - mz) / params.mover_height,
                         0.0, 1.0)
        f_obj_c = forces.f_obj * zf[:, None]
        f_imp_c = forces.f_imp * zf
        f_z_c = forces.f_z * zf
        torque_c = forces.torque_obj * zf
        # mover z: the soft impedance against the vertical friction reaction
        zacc = (params.imp_k * (params.initial_zpos - mz) - params.imp_d * mvz + f_z_c) / params.total_mass
        new_mvz = mvz + dt * zacc
        new_mz = torch.clamp(mz + dt * new_mvz, min=0.0)
        # body qacc: the gain-scaled command plus the contact reaction over
        # the total body mass
        qacc = params.accel_scale * ctrl_acc + (-f_obj_c) / params.total_mass
        new_vel = vel + dt * qacc
        new_pos = pos + dt * new_vel

        obj_acc = f_obj_c / params.object_mass
        damp = 1.0 + dt * params.object_damping / params.object_mass
        v_obj = (obj_vel + dt * obj_acc) / damp
        # floor friction under the plow load
        load = (1.0 + torch.minimum(params.plow_kappa * f_imp_c / mg, params.plow_cap)
                + torch.minimum(params.cone_plow * f_z_c / mg, params.cone_plow_cap))
        v_obj = contact.coulomb_floor_step(v_obj, (mu_g_dt * load)[:, None])
        new_obj_pos = obj_pos + dt * v_obj
        damp_w = 1.0 + dt * params.object_damping / params.obj_inertia
        w_obj = (obj_w + dt * torque_c / params.obj_inertia) / damp_w
        w_obj = contact.coulomb_spin_step(w_obj, params.mu_spin * dt * load)
        new_obj_yaw = obj_yaw + dt * w_obj

        new_wall = _wall_collision_with_noise(config, params, new_pos, pose_noise[k], with_offset=False)

        d2 = done[:, None]
        pos = torch.where(d2, pos, new_pos)
        vel = torch.where(d2, vel, new_vel)
        acc = torch.where(d2, acc, qacc)
        act = torch.where(d2, act, new_act)
        obj_pos = torch.where(d2, obj_pos, new_obj_pos)
        obj_vel = torch.where(d2, obj_vel, v_obj)
        obj_yaw = torch.where(done, obj_yaw, new_obj_yaw)
        obj_w = torch.where(done, obj_w, w_obj)
        mz = torch.where(done, mz, new_mz)
        mvz = torch.where(done, mvz, new_mvz)
        # the carried axis dies when the climb breaks contact (zf == 0)
        c_axis = torch.where(done, c_axis, torch.where(zf > 0, forces.axis, -1.0))
        wall = torch.where(done, wall, new_wall)
        done = done | wall
        cycles.append((pos, vel, obj_pos, obj_yaw, done))

    new_state = PushingState(pos=pos, vel=vel, acc=acc, act=act, obj_pos=obj_pos, obj_vel=obj_vel, obj_yaw=obj_yaw,
                             obj_w=obj_w, mover_z=mz, mover_vz=mvz, goal=state.goal, steps=state.steps + 1)
    obs = _get_obs(config, params, new_state, generator, noise['obs'])
    info = _get_info(params, obs, wall)
    if config.reward_mode == 'dense':
        # the training shaping: object-to-goal distance plus an approach
        # term that fades at contact range and turns into a retreat bonus
        # once the object is at the goal
        d_og = dynamics.norm(obj_pos - new_state.goal)
        d_mo = dynamics.norm(pos - obj_pos)
        near = d_og <= params.threshold_pos
        approach = -0.3 * torch.clamp(d_mo - 0.105, min=0.0)
        retreat = 0.5 * torch.clamp(d_mo, max=0.15)
        shaped = -d_og + torch.where(near, retreat, approach)
        reward = torch.where(wall, REWARD_WALL_COLLISION, shaped).to(dtype)
    else:
        reward = compute_reward(params, obs['achieved_goal'], obs['desired_goal'], wall)
    stacked = tuple(torch.stack(leaf, dim=1) for leaf in zip(*cycles))
    return (new_state, obs, reward, wall, torch.zeros_like(wall), info), stacked


def step(config: PushingConfig, params: PushingParams, state: PushingState, action, noise=None, generator=None):
    """One eager env step of every env (see ``_step_core``): ``(state, obs,
    reward, terminated, truncated, info)``; terminated on a wall hit."""
    return _step_core(config, params, state, action, noise, generator)[0]


def step_with_cycles(config: PushingConfig, params: PushingParams, state: PushingState, action, noise=None,
                     generator=None):
    """``step`` plus the per-cycle ``(pos, vel, obj_pos, obj_yaw, done)``
    stacks ``[B, C, ...]`` for a per-cycle replay; ``done`` stops it at the
    colliding cycle."""
    out, cyc = _step_core(config, params, state, action, noise, generator)
    return (*out, cyc)


def step_autoreset(config: PushingConfig, params: PushingParams, state: PushingState, action, noise=None,
                   generator=None):
    """``step`` with the restart of every env that terminated or reached the
    time limit: the pre-reset observation goes to
    ``info['final_observation']``; an env whose object resampling stalled
    stays un-reset (``info['reset_stalled']``) and retries on the next step.
    The restarts are drawn from ``generator``."""
    new_state, obs, reward, terminated, _, info = step(config, params, state, action, noise, generator)
    truncated = new_state.steps >= config.max_episode_steps
    done = terminated | truncated
    reset_state, reset_obs, reset_info = reset(config, params, state.pos.shape[0], generator)
    do_reset = done & ~reset_info['reset_stalled']
    kept = common.autoreset_select(do_reset, new_state, reset_state)
    out_obs = {k: common.where_done(do_reset, reset_obs[k], v) for k, v in obs.items()}
    info = dict(info, final_observation=obs, reset_stalled=done & reset_info['reset_stalled'],
                reset_trials=torch.where(done, reset_info['reset_trials'], 0))
    return kept, out_obs, reward, terminated, truncated, info


batched_step = step
batched_step_autoreset = step_autoreset


def _require_sparse(config: PushingConfig) -> None:
    if config.reward_mode != 'sparse':
        raise ValueError("the fused pushing paths compute the sparse reward in-plane; reward_mode='dense' "
                         'comes with the eager step (ROADMAP.md)')


def _limit(config: PushingConfig, params: PushingParams) -> float:
    return float(params.j_max if config.learn_jerk else params.a_max)


def _action_planes(action: torch.Tensor, b: int, limit: float) -> torch.Tensor:
    return torch.clamp(action.to(torch.float32).reshape(b, 2), -limit, limit).T.contiguous()


# ---------------------------------------------------------------------------
# fused serving path
# ---------------------------------------------------------------------------


def make_fused_step(config: PushingConfig, params: PushingParams):
    """Batched pushing step with the whole cycle loop (incl. contact) in one
    launch of kernel B; returns ``step_fn(state, action, noise=None,
    seed=None, generator=None) -> (state, obs, reward, terminated,
    truncated, info)``.

    ``noise``: ``[step_fn.noise_planes, B]`` uniforms for the cycles (the
    injected mode); without it CPU tensors draw them from ``generator`` and
    the kernel draws its Philox stream under ``seed`` (from ``generator``
    when not given).  The observation noise is drawn from ``generator``."""
    _require_sparse(config)
    kc = kpush.make_kernel_consts(config, params)
    limit = _limit(config, params)

    def step_fn(state: PushingState, action, noise=None, seed=None, generator=None):
        b = state.pos.shape[0]
        planes = torch.cat([state_to_planes(state)[:16], _action_planes(action, b, limit)])
        out = kpush.pushing_cycles(planes, kc, uniforms=noise, seed=seed, generator=generator)
        new_state = PushingState(
            pos=_pair(out, 0), vel=_pair(out, 2), acc=_pair(out, 4), act=_pair(out, 6),
            obj_pos=_pair(out, 8), obj_vel=_pair(out, 10), obj_yaw=out[12].clone(), obj_w=out[13].clone(),
            mover_z=out[14].clone(), mover_vz=out[15].clone(), goal=state.goal, steps=state.steps + 1,
        )
        wall = out[16] > 0.5
        obs = _get_obs(config, params, new_state, generator)
        info = _get_info(params, obs, wall)
        reward = compute_reward(params, obs['achieved_goal'], obs['desired_goal'], wall)
        terminated = reward == REWARD_WALL_COLLISION
        truncated = torch.zeros_like(wall)
        return new_state, obs, reward, terminated, truncated, info

    step_fn.noise_planes = kpush.cycles_noise_planes(config.num_cycles, kc.box)
    return step_fn


def make_fused_step_autoreset(config: PushingConfig, params: PushingParams, cand_k: int = 32):
    """Fused pushing step + episode restart in one launch of kernel C
    (cycles, termination, restart sampling, both observations).  A stalled
    restart leaves the env un-reset and reports ``info['reset_stalled']``
    (retried next step).  Same signature as ``make_fused_step``."""
    _require_sparse(config)
    kc = kpush.make_kernel_consts(config, params, cand_k)
    limit = _limit(config, params)
    thr = float(params.threshold_pos)

    def step_fn(state: PushingState, action, noise=None, seed=None, generator=None):
        b = state.pos.shape[0]
        out = kpush.pushing_autoreset(state_to_planes(state), _action_planes(action, b, limit), kc,
                                      uniforms=noise, seed=seed, generator=generator)
        new_state = planes_to_state(out)
        old_goal = state.goal.to(torch.float32)
        f_mp, f_mv, f_ag, f_acc = (_pair(out, i) for i in (25, 27, 29, 31))
        s_mp, s_mv, s_ag = (_pair(out, i) for i in (19, 21, 23))
        wall = out[33] > 0.5

        dist = torch.linalg.vector_norm(f_ag - old_goal, dim=-1)
        reached = dist <= thr
        reward = torch.where(wall, REWARD_WALL_COLLISION, torch.where(reached, 0.0, -1.0))
        truncated = (state.steps + 1) >= config.max_episode_steps
        info = {
            'is_success': reached & ~wall,
            'mover_collision': torch.zeros_like(wall),
            'wall_collision': wall,
            'final_observation': _obs_dict(config, f_mp, f_mv, f_acc, f_ag, old_goal),
            'reset_stalled': out[34] > 0.5,
            'reset_trials': out[35].to(torch.int32),
        }
        obs = _obs_dict(config, s_mp, s_mv, new_state.acc, s_ag, new_state.goal)
        return new_state, obs, reward, wall, truncated, info

    step_fn.noise_planes = kpush.autoreset_noise_planes(config.num_cycles, cand_k, kc.box)
    return step_fn


def _make_rollout(config: PushingConfig, params: PushingParams, steps_per_launch: int, step_impl, chunk_impl):
    """The rollout loop shared by ``make_fused_rollout`` and the card's
    plain-version timing: ``step_impl(planes [19, B], action [2, B], seed)
    -> [36, B]`` (one autoreset step), ``chunk_impl(planes, actions [K, 2,
    B], seed) -> (planes, [3, K, B])`` (K steps)."""
    limit = _limit(config, params)
    thr = float(params.threshold_pos)
    max_steps = float(config.max_episode_steps)

    @profiling.spanned(profiling.ROLLOUT)
    def rollout(state: PushingState, actions, seed: int):
        b = state.pos.shape[0]
        actions = torch.clamp(actions.to(torch.float32).reshape(-1, b, 2), -limit, limit)
        action_planes = actions.permute(0, 2, 1).contiguous()  # [T, 2, B]
        T = action_planes.shape[0]
        planes = state_to_planes(state)
        if steps_per_launch > 1:
            # chunks of K steps, the last one shorter when K does not divide T
            sig = []
            for c, t0 in enumerate(range(0, T, steps_per_launch)):
                planes, s = chunk_impl(planes, action_planes[t0 : t0 + steps_per_launch], seed + c)
                sig.append(s)
            wall, reached, trunc = torch.cat(sig, dim=1)
        else:
            walls, reach, truncs = [], [], []
            restarts = [] if profiling.TRACER.counters_on else None
            for t in range(T):
                out = step_impl(planes, action_planes[t], seed + t)
                # reference scoring from the pre-reset observation: achieved
                # (outputs 29/30) vs the OLD goal (carried planes 16/17)
                ddx = out[29] - planes[16]
                ddy = out[30] - planes[17]
                reach.append(torch.where(torch.sqrt(ddx * ddx + ddy * ddy) <= thr, 1.0, 0.0))
                truncs.append(torch.where(planes[18] + 1.0 >= max_steps, 1.0, 0.0))
                walls.append(out[33])
                if restarts is not None:
                    restarts.append(out[34:36])
                planes = out[:19]
            wall, reached, trunc = torch.stack(walls), torch.stack(reach), torch.stack(truncs)
            if restarts is not None:
                profiling.count_restarts(restarts)
        rew = torch.where(wall > 0.5, REWARD_WALL_COLLISION, torch.where(reached > 0.5, 0.0, -1.0))
        return planes_to_state(planes), rew, wall > 0.5, trunc > 0.5

    return rollout


def make_fused_rollout(config: PushingConfig, params: PushingParams, cand_k: int = 32, steps_per_launch: int = 1):
    """Plane-form rollout: the state stays in the kernels' ``[19, B]`` plane
    layout across all steps, actions are given up front.

    ``steps_per_launch == 1`` launches kernel C once per step (seed
    ``seed + t``); ``steps_per_launch = K > 1`` launches kernel D over
    chunks of K steps plus one tail chunk (seed ``seed + chunk``).  On CPU
    tensors the plain versions draw their uniforms from a generator seeded
    the same way.

    Returns ``rollout(state, actions [T, B, 2], seed) -> (final state,
    rewards [T, B], terminated [T, B], truncated [T, B])``."""
    _require_sparse(config)
    kc = kpush.make_kernel_consts(config, params, cand_k)

    def step_impl(planes, action, seed):
        return kpush.pushing_autoreset(planes, action, kc, seed=seed, generator=common.seeded_generator(planes, seed))

    def chunk_impl(planes, actions, seed):
        return kpush.pushing_rollout(planes, actions, kc, seed=seed, generator=common.seeded_generator(planes, seed))

    return _make_rollout(config, params, steps_per_launch, step_impl, chunk_impl)


def make_reactive_rollout(config: PushingConfig, params: PushingParams, policy_step, num_steps: int,
                          cand_k: int = 32, dense_reward: bool = False):
    """Plane-form rollout driven by a policy in the loop: the state stays in
    the kernels' ``[19, B]`` plane layout across all steps, as in
    ``make_fused_rollout``, while ``policy_step`` picks each action from the
    12 observation features that kernel C-feat emits beside its planes.

    ``policy_step(pol, noise_or_generator, obs_pm [12, B]) -> (action [2, B],
    aux)``: plane-major on both sides (``ppo.apply_pm``); the features are
    the training recipes' layout (mover position and velocity, achieved,
    goal, achieved - mover, goal - achieved); ``aux`` is a tensor or a
    (nested) tuple of tensors, batch last (PPO's ``(raw [A, B], logp [B],
    value [B])``).  Step ``t`` gets ``policy_xs[t]`` when ``policy_xs`` is
    given (e.g. PPO's pre-drawn exploration noise ``[T, A, B]``), else the
    rollout's ``generator``.

    Returns ``rollout(state, pol, generator, seed, policy_xs=None) ->
    (final state, traj, last_obs_vec [B, 12])`` with ``traj = (obs_vec [T,
    B, 12], aux [T, B, ...], reward [T, B], terminated [T, B], truncated [T,
    B], final_vec [T, B, 12])``; ``final_vec`` is the pre-reset
    observation's features (the truncation bootstrap).  ``reward`` is the
    sparse scoring, or with ``dense_reward`` the training shaping of
    ``reward_mode='dense'``, both from the pre-reset feature block.  As in
    the JAX package, the first observation is noise-free (assembled from the
    state planes) and step ``t`` launches kernel C-feat with seed ``seed +
    t``; on CPU tensors its plain version draws from a generator seeded the
    same way.  Acceleration mode and f32 only, as in the JAX package."""
    if config.learn_jerk:
        raise ValueError('the reactive rollout runs in acc mode only (the 12-feature recipe layout)')
    if params.v_max.dtype != torch.float32:
        raise ValueError('the reactive rollout runs in f32 only: the f64 parity mode has no fused kernel')
    kc = kpush.make_kernel_consts(config, params, cand_k)
    a_max, thr = float(params.a_max), float(params.threshold_pos)
    max_steps = float(config.max_episode_steps)

    @profiling.spanned(profiling.POLICY)
    def act(pol, x, feat):
        action, aux = policy_step(pol, x, feat)
        return torch.clamp(action.to(torch.float32), -a_max, a_max).contiguous(), aux

    @profiling.spanned(profiling.ROLLOUT)
    def rollout(state: PushingState, pol, generator, seed: int, policy_xs=None):
        planes = state_to_planes(state)
        feat0 = kpush.feature_block(*planes[0:4], planes[8], planes[9], planes[16], planes[17])
        feat, auxs, blocks, walls, steps = feat0, [], [], [], []
        restarts = [] if profiling.TRACER.counters_on else None
        for t in range(num_steps):
            action, aux = act(pol, generator if policy_xs is None else policy_xs[t], feat)
            out, block = kpush.pushing_autoreset(planes, action, kc, seed=seed + t, emit_features=True,
                                                 generator=common.seeded_generator(planes, seed + t))
            auxs.append(aux)
            blocks.append(block)
            walls.append(out[33])
            steps.append(planes[18])
            if restarts is not None:
                restarts.append(out[34:36])
            planes, feat = out[:19], block[0]
        if restarts is not None:
            profiling.count_restarts(restarts)
        # rewards and flags once per rollout over [T, B] (they do not feed
        # back into the loop): fewer launches per step on the card
        blocks = torch.stack(blocks)  # [T, 2, 12, B]
        fin = blocks[:, 1]
        d_og = sqrt(fin[:, 10] * fin[:, 10] + fin[:, 11] * fin[:, 11])  # old goal - achieved
        reached = d_og <= thr
        term = torch.stack(walls) > 0.5
        if dense_reward:
            d_mo = sqrt(fin[:, 8] * fin[:, 8] + fin[:, 9] * fin[:, 9])  # achieved - mover
            approach = -0.3 * torch.clamp(d_mo - 0.105, min=0.0)
            retreat = 0.5 * torch.clamp(d_mo, max=0.15)
            shaped = -d_og + torch.where(reached, retreat, approach)
            reward = torch.where(term, REWARD_WALL_COLLISION, shaped)
        else:
            reward = torch.where(term, REWARD_WALL_COLLISION, torch.where(reached, 0.0, -1.0))
        trunc = torch.stack(steps) + 1.0 >= max_steps
        obs = torch.cat([feat0[None], blocks[:-1, 0]])
        traj = (obs.transpose(1, 2), common.stack_batch_last(auxs), reward, term, trunc, fin.transpose(1, 2))
        return planes_to_state(planes), traj, feat.T

    return rollout
