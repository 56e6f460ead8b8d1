"""Pushing kernels B, C and D: wrappers, plain PyTorch versions, constants.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/pallas_step.py``:

- kernel B, ``pushing_cycles``: ``_pushing_kernel`` / ``_make_pushing_cycles``
  (one env step of ``num_cycles`` control cycles, no restart);
- kernel C, ``pushing_autoreset``: ``_pushing_autoreset_kernel`` /
  ``_pushing_autoreset_step`` (cycles, termination, observations, in-kernel
  restart); with ``emit_features`` (C-feat) also the two ``[12, B]`` policy
  feature blocks of the reactive rollout (``pallas_step.py:1066-1078``);
- kernel D, ``pushing_rollout``: ``_pushing_rollout_kernel`` (K autoreset
  steps in one launch).

Each kernel comes in the circle and the box collision shape (``kc.box``):
the box's per-cycle wall check draws two more normal pairs (the quaternion
noise) and tests the rotated rectangle's vertices, and its launches count
under the kernel's name with ``_box`` appended.

State travels as structure-of-arrays f32 planes ``[planes, B]``: the 16
physics planes (pos, vel, acc, act, obj_pos, obj_vel x/y pairs, yaw, omega,
mover z, mover vz), then goal x/y and the step counter for the 19-plane
autoreset state.  The plain versions do the kernels' plane arithmetic with
the same operand order and the same draw order, over a given uniform tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build, to_numpy
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import clamp_chain, scalar
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import UniformStream
from gymnasium_planar_robotics_tpu_torch.ops.kernels.walls import (box_valid_full, circle_valid_full, full_layout_bounds,
                                                                   grid_np, quat_to_R2, wall_sizes)

#: field order of ``gprt::Consts`` in ``csrc/pushing.cuh``
CONST_FIELDS = (
    'v_max', 'a_max', 'dt', 'std_pos', 'std_vel', 'accel_scale', 'total_mass',
    'mover_hx', 'mover_hy', 'obj_hx', 'obj_hy', 'obj_mass', 'contact_k',
    'contact_b', 'contact_bt', 'contact_mu', 'mu_g_dt', 'obj_inertia',
    'plow_unit', 'plow_cap', 'cone_zeta', 'cone_vt', 'cone_vt_off',
    'cone_vt_span', 'conez_unit', 'conez_cap', 'mover_height', 'obj_height',
    'imp_k', 'imp_d', 'z0', 'fz_cap0', 'fz_slope', 'damp', 'damp_w',
    'mu_spin_dt', 'wall_x', 'wall_y', 'x0', 'x1', 'y0', 'y1', 'has_fast', 'fx0',
    'fx1', 'fy0', 'fy1', 'object_noise', 'max_episode_steps', 'min_x', 'min_y',
    'span_x', 'span_y', 'obj_min_x', 'obj_min_y', 'obj_span_x', 'obj_span_y',
    'min_mo', 'threshold',
)

N_STATE = 19  # autoreset state planes
N_AUTORESET_OUT = 36  # 19 state + post-reset obs 6 + pre-reset obs 8 + wall, stalled, trials
N_FEATURES = 12  # rows of one policy feature block


def cycles_noise_planes(num_cycles: int, box: bool = False) -> int:
    """Uniforms one step of cycles draws: per cycle a velocity pair and the
    wall check's pose, one pair (circle) or three (box: xy, then the
    quaternion noise) (``pallas_step._step_noise_planes``)."""
    return (2 + 2 * (3 if box else 1)) * num_cycles


def autoreset_noise_planes(num_cycles: int, cand_k: int, box: bool = False) -> int:
    """cycles + pre-obs (3 pairs) + restart (mover 2 + object 2*cand_k +
    goal 2) + post-obs (3 pairs)."""
    return cycles_noise_planes(num_cycles, box) + 16 + 2 * cand_k


# ---------------------------------------------------------------------------
# constants (host side, float64 as the Pallas kernels form them)
# ---------------------------------------------------------------------------


def pushing_consts(config, params) -> dict:
    """The pushing kernels' trace-time constants (``pallas_step._pushing_consts``)."""
    p = {f.name: to_numpy(getattr(params, f.name)) for f in dataclasses.fields(params) if f.name != 'grid'}
    return dict(
        grid_np=grid_np(params),
        num_cycles=config.num_cycles,
        learn_jerk=config.learn_jerk,
        box=config.collision_shape == 'box',
        # during cycles c + offset_wall: the circle's radius, the box's half-extents
        wall_size=wall_sizes(config, params)[0],
        v_max=float(p['v_max']),
        a_max=float(p['a_max']),
        dt=float(p['dt']),
        std_pos=float(p['std_noise'][0]),
        std_vel=float(p['std_noise'][1]),
        mover_mass=float(p['mover_mass']),
        accel_scale=float(p['accel_scale']),
        total_mass=float(p['total_mass']),
        mover_hx=float(p['mover_half'][0]),
        mover_hy=float(p['mover_half'][1]),
        obj_hx=float(p['object_half'][0]),
        obj_hy=float(p['object_half'][1]),
        obj_mass=float(p['object_mass']),
        obj_damping=float(p['object_damping']),
        contact_k=float(p['contact_k']),
        contact_b=float(p['contact_b']),
        contact_bt=float(p['contact_bt']),
        contact_mu=float(p['contact_mu']),
        mu_g_dt=float(p['floor_mu'] * p['gravity'] * p['dt']),
        obj_inertia=float(p['obj_inertia']),
        mu_spin=float(p['mu_spin']),
        plow_unit=float(p['plow_kappa'] / (p['object_mass'] * p['gravity'])),
        plow_cap=float(p['plow_cap']),
        cone_zeta=float(p['cone_zeta']),
        cone_vt=float(p['cone_vt']),
        cone_vt_hi=float(p['cone_vt_hi']),
        cone_vt_off=float(p['cone_vt_off']),
        conez_unit=float(p['cone_plow'] / (p['object_mass'] * p['gravity'])),
        conez_cap=float(p['cone_plow_cap']),
        mover_height=float(p['mover_height']),
        obj_height=float(p['object_height']),
        imp_k=float(p['imp_k']),
        imp_d=float(p['imp_d']),
        z0=float(p['initial_zpos']),
        fz_cap0=float(p['cone_fz_cap']),
        fz_slope=float(p['cone_fz_slope']),
    )


def reset_consts(config, params, cand_k: int) -> dict:
    """The autoreset kernel's restart constants
    (``make_fused_pushing_autoreset_cycles``)."""
    std = to_numpy(params.std_noise)
    mn, mx = to_numpy(params.min_xy), to_numpy(params.max_xy)
    omn, omx = to_numpy(params.obj_min_xy), to_numpy(params.obj_max_xy)
    return dict(
        std_pos=float(std[0]),
        std_vel=float(std[1]),
        object_noise=float(to_numpy(params.object_noise)),
        max_episode_steps=float(config.max_episode_steps),
        min_x=float(mn[0]),
        min_y=float(mn[1]),
        max_x=float(mx[0]),
        max_y=float(mx[1]),
        obj_min_x=float(omn[0]),
        obj_min_y=float(omn[1]),
        obj_max_x=float(omx[0]),
        obj_max_y=float(omx[1]),
        min_mo=float(to_numpy(params.min_mo_dist)),
        threshold=float(to_numpy(params.threshold_pos)),
        cand_k=cand_k,
    )


@dataclasses.dataclass(frozen=True)
class KernelConsts:
    """Everything a pushing kernel launch needs besides its tensors.

    ``f`` maps each ``CONST_FIELDS`` name to its f32 value (as a Python
    float); ``vector`` is the same in field order, the bytes of
    ``gprt::Consts``."""

    f: dict
    vector: np.ndarray
    num_cycles: int
    cand_k: int
    learn_jerk: bool
    box: bool


def make_kernel_consts(config, params, cand_k: int = 32) -> KernelConsts:
    pc = pushing_consts(config, params)
    rc = reset_consts(config, params, cand_k)
    g = pc['grid_np']
    if not g['layout'].all():
        raise NotImplementedError('the pushing kernels cover the fully populated 3x3 table (ROADMAP.md)')
    (x0, x1, y0, y1), fast = full_layout_bounds(g)
    # sums the Pallas kernel forms in Python float64 before rounding to f32
    v = dict(pc)
    wall_x, wall_y = pc['wall_size'] if pc['box'] else (pc['wall_size'],) * 2
    v.update(
        wall_x=wall_x, wall_y=wall_y,
        cone_vt_span=pc['cone_vt_off'] - pc['cone_vt_hi'],
        damp=1.0 + pc['dt'] * pc['obj_damping'] / pc['obj_mass'],
        damp_w=1.0 + pc['dt'] * pc['obj_damping'] / pc['obj_inertia'],
        mu_spin_dt=pc['mu_spin'] * pc['dt'],
        x0=x0, x1=x1, y0=y0, y1=y1,
        has_fast=0.0 if fast is None else 1.0,
        fx0=0.0 if fast is None else fast[0],
        fx1=0.0 if fast is None else fast[1],
        fy0=0.0 if fast is None else fast[2],
        fy1=0.0 if fast is None else fast[3],
        object_noise=rc['object_noise'],
        max_episode_steps=rc['max_episode_steps'],
        min_x=rc['min_x'], min_y=rc['min_y'],
        span_x=rc['max_x'] - rc['min_x'], span_y=rc['max_y'] - rc['min_y'],
        obj_min_x=rc['obj_min_x'], obj_min_y=rc['obj_min_y'],
        obj_span_x=rc['obj_max_x'] - rc['obj_min_x'], obj_span_y=rc['obj_max_y'] - rc['obj_min_y'],
        min_mo=rc['min_mo'], threshold=rc['threshold'],
    )
    vector = np.array([v[k] for k in CONST_FIELDS], dtype=np.float32)
    f = {k: float(x) for k, x in zip(CONST_FIELDS, vector)}
    return KernelConsts(f=f, vector=vector, num_cycles=config.num_cycles, cand_k=cand_k,
                        learn_jerk=bool(config.learn_jerk), box=pc['box'])


def launch_name(name: str, kc: KernelConsts) -> str:
    """The ``LAUNCHES`` key of kernel ``name`` in ``kc``'s collision shape."""
    return name + '_box' if kc.box else name


# ---------------------------------------------------------------------------
# plain versions (same plane arithmetic, same draw order)
# ---------------------------------------------------------------------------


def _wall_pose_plain(f: dict, noise: UniformStream, box: bool):
    """The per-cycle wall check's noise (``_make_wall_checker.check``): the
    position normal pair, for the box also the rotation ``R`` of the
    quaternion noise around the identity (None for the circle)."""
    sp = f['std_pos']
    nwx, nwy = noise.normal_pair()
    if not box:
        return nwx, nwy, None
    q1, q2 = noise.normal_pair()
    q3, q4 = noise.normal_pair()
    return nwx, nwy, quat_to_R2(1.0 + q1 * sp, q2 * sp, q3 * sp, q4 * sp)


def _wall_ok_plain(f: dict, pose, box: bool, npx, npy):
    """The noisy wall check on the fully populated table at the noise
    ``pose`` of ``_wall_pose_plain``.  True = no wall collision."""
    nwx, nwy, R = pose
    sp = f['std_pos']
    if not box:
        return circle_valid_full(f, npx + nwx * sp, npy + nwy * sp, f['wall_x'])
    return box_valid_full(f, npx + nwx * sp, npy + nwy * sp, R, f['wall_x'], f['wall_y'])


def cycle_draws_plain(f: dict, noise: UniformStream, num_cycles: int, box: bool):
    """The state-independent values of ``num_cycles`` control cycles, in
    draw order: per cycle the velocity normal pair, then the wall pose
    (``_wall_pose_plain``).  A list draws them all now; the cycles consume
    them in the same order either way."""
    return [(noise.normal_pair(), _wall_pose_plain(f, noise, box)) for _ in range(num_cycles)]


def _run_cycles_plain(f: dict, cycle_draws, learn_jerk: bool, box: bool, phys, ux, uy):
    """``_make_pushing_cycles.run``: 16 physics planes in, 16 out + wall,
    one cycle per entry of ``cycle_draws`` (``cycle_draws_plain``)."""
    px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz = phys
    dt = f['dt']
    dt_t = scalar(dt, px)
    done_f = torch.zeros_like(px)
    wall_f = torch.zeros_like(px)
    caxis = torch.full_like(px, -1.0)  # hysteretic normal axis, per step only
    for (nvx, nvy), wall_pose in cycle_draws:
        done = done_f > 0.0
        vmx = vx + nvx * f['std_vel']
        vmy = vy + nvy * f['std_vel']
        if learn_jerk:
            # measured acceleration: the last qacc; integrator state: act
            nkx, nky = clamp_chain(True, f['v_max'], f['a_max'], dt, dt_t, vmx, vmy, ux, uy, ax, ay, kx, ky)
            ctrl_x, ctrl_y = nkx, nky
        else:
            ctrl_x, ctrl_y = clamp_chain(False, f['v_max'], f['a_max'], dt, dt_t, vmx, vmy, ux, uy, ax, ay, kx, ky)
            nkx, nky = kx, ky

        # corner-aware penalty contact from the pre-integration state
        cos_y = torch.cos(oyaw)
        sin_y = torch.sin(oyaw)
        rx = torch.abs(cos_y) * f['obj_hx'] + torch.abs(sin_y) * f['obj_hy']
        ry = torch.abs(sin_y) * f['obj_hx'] + torch.abs(cos_y) * f['obj_hy']
        dx_, dy_ = ox - px, oy - py
        olx = (f['mover_hx'] + rx) - torch.abs(dx_)
        oly = (f['mover_hy'] + ry) - torch.abs(dy_)
        in_contact = (olx > 0) & (oly > 0)
        olx_c = torch.clamp(olx, min=0.0)
        oly_c = torch.clamp(oly, min=0.0)
        sx_ = torch.where(dx_ == 0, 1.0, torch.sign(dx_))
        sy_ = torch.where(dy_ == 0, 1.0, torch.sign(dy_))
        axis_x = olx_c <= oly_c
        keep_x = (caxis == 0.0) & (olx > 0)
        keep_y = (caxis == 1.0) & (oly > 0)
        axis_x = keep_x | (axis_x & ~keep_y)
        n_x = torch.where(axis_x, sx_, 0.0)
        n_y = torch.where(axis_x, 0.0, sy_)
        pen = torch.where(axis_x, olx_c, oly_c)
        new_caxis = torch.where(in_contact, torch.where(axis_x, 0.0, 1.0), -1.0)

        lo_x = torch.maximum(px - f['mover_hx'], ox - rx)
        hi_x = torch.minimum(px + f['mover_hx'], ox + rx)
        lo_y = torch.maximum(py - f['mover_hy'], oy - ry)
        hi_y = torch.minimum(py + f['mover_hy'], oy + ry)
        cpx = 0.5 * (lo_x + hi_x)
        cpy = 0.5 * (lo_y + hi_y)
        r_ox = cpx - ox
        r_oy = cpy - oy
        v_obj_cx = wvx - ow * r_oy
        v_obj_cy = wvy + ow * r_ox
        vrx = v_obj_cx - vx
        vry = v_obj_cy - vy
        vn = vrx * n_x + vry * n_y
        fn_mag = torch.clamp(f['contact_k'] * pen - f['contact_b'] * vn, min=0.0)
        t_x = -n_y
        t_y = n_x
        vt = vrx * t_x + vry * t_y
        f_imp_r = torch.minimum(torch.clamp(-f['contact_b'] * vn, min=0.0), fn_mag)
        avt = torch.abs(vt)
        slip = torch.clamp(avt / f['cone_vt'], max=1.0) * torch.clamp(
            (f['cone_vt_off'] - avt) / f['cone_vt_span'], 0.0, 1.0
        )
        fz_cap = f['fz_cap0'] + f['fz_slope'] * torch.clamp(mz - f['z0'], min=0.0)
        f_z = torch.minimum(f['cone_zeta'] * fn_mag * slip, fz_cap)
        budget = f['contact_mu'] * fn_mag
        cap = torch.where(f_z > 0, torch.sqrt(torch.clamp(budget * budget - f_z * f_z, min=0.0)), budget)
        ft_mag = torch.clamp(-f['contact_bt'] * vt, -cap, cap)
        cmask = torch.where(in_contact, 1.0, 0.0)
        zf = torch.clamp(
            (torch.clamp(mz + f['mover_height'], max=f['obj_height']) - mz) / f['mover_height'], 0.0, 1.0
        )
        f_obj_x = (fn_mag * n_x + ft_mag * t_x) * cmask * zf
        f_obj_y = (fn_mag * n_y + ft_mag * t_y) * cmask * zf
        torque = r_ox * f_obj_y - r_oy * f_obj_x
        f_z_c = f_z * cmask * zf
        zacc = (f['imp_k'] * (f['z0'] - mz) - f['imp_d'] * mvz + f_z_c) / f['total_mass']
        new_mvz = mvz + dt * zacc
        new_mz = torch.clamp(mz + dt * new_mvz, min=0.0)

        qacc_x = f['accel_scale'] * ctrl_x + (-f_obj_x) / f['total_mass']
        qacc_y = f['accel_scale'] * ctrl_y + (-f_obj_y) / f['total_mass']
        nvx_t = vx + dt * qacc_x
        nvy_t = vy + dt * qacc_y
        npx = px + dt * nvx_t
        npy = py + dt * nvy_t

        fimp = f_imp_r * cmask * zf
        load = (1.0 + torch.clamp(f['plow_unit'] * fimp, max=f['plow_cap'])
                + torch.clamp(f['conez_unit'] * f_z_c, max=f['conez_cap']))
        ovx_t = (wvx + dt * (f_obj_x / f['obj_mass'])) / f['damp']
        ovy_t = (wvy + dt * (f_obj_y / f['obj_mass'])) / f['damp']
        speed = torch.sqrt(ovx_t * ovx_t + ovy_t * ovy_t)
        scale = torch.clamp(1.0 - f['mu_g_dt'] * load / torch.clamp(speed, min=1e-12), min=0.0)
        ovx_t = ovx_t * scale
        ovy_t = ovy_t * scale
        nox = ox + dt * ovx_t
        noy = oy + dt * ovy_t
        ow_t = (ow + dt * torque / f['obj_inertia']) / f['damp_w']
        ow_t = torch.sign(ow_t) * torch.clamp(torch.abs(ow_t) - f['mu_spin_dt'] * load, min=0.0)
        noyaw = oyaw + dt * ow_t

        new_wall_f = torch.where(_wall_ok_plain(f, wall_pose, box, npx, npy), 0.0, 1.0)

        px = torch.where(done, px, npx)
        py = torch.where(done, py, npy)
        vx = torch.where(done, vx, nvx_t)
        vy = torch.where(done, vy, nvy_t)
        ax = torch.where(done, ax, qacc_x)
        ay = torch.where(done, ay, qacc_y)
        kx = torch.where(done, kx, nkx)
        ky = torch.where(done, ky, nky)
        ox = torch.where(done, ox, nox)
        oy = torch.where(done, oy, noy)
        wvx = torch.where(done, wvx, ovx_t)
        wvy = torch.where(done, wvy, ovy_t)
        oyaw = torch.where(done, oyaw, noyaw)
        ow = torch.where(done, ow, ow_t)
        mz = torch.where(done, mz, new_mz)
        mvz = torch.where(done, mvz, new_mvz)
        # the carried axis dies when the climb breaks contact (zf == 0)
        caxis = torch.where(done, caxis, torch.where(zf > 0, new_caxis, -1.0))
        wall_f = torch.where(done, wall_f, new_wall_f)
        done_f = torch.maximum(done_f, wall_f)
    return [px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz], wall_f


@dataclasses.dataclass
class StepDraws:
    """The state-independent values of one autoreset step, all drawn from
    the uniform planes in the Pallas order: the cycles' draws
    (``cycle_draws_plain``), the pre-reset observation normals ``n`` (3
    pairs), the restart's result (``restart_plain``) and the post-reset
    observation normals ``m`` (3 pairs).  The kernels' producer warps compute
    the same values ahead of the physics."""

    cycles: list
    n: tuple
    restart: tuple
    m: tuple


def restart_plain(f: dict, noise: UniformStream, cand_k: int):
    """The in-kernel restart's draws: mover uniform, object the first of
    ``cand_k`` candidates farther than ``min_mo`` from the mover (else the
    first candidate), goal uniform.  Returns ``(rmx, rmy, rox, roy, found,
    trials, rgx, rgy)``; ``trials`` is 1 + j for the first accepted
    candidate j, else ``cand_k``.  It reads no state."""
    rmx = noise.uniform_in(f['min_x'], f['span_x'])
    rmy = noise.uniform_in(f['min_y'], f['span_y'])
    rox = noise.uniform_in(f['obj_min_x'], f['obj_span_x'])
    roy = noise.uniform_in(f['obj_min_y'], f['obj_span_y'])
    d0x, d0y = rox - rmx, roy - rmy
    found = torch.where(torch.sqrt(d0x * d0x + d0y * d0y) > f['min_mo'], 1.0, 0.0)
    trials = torch.ones_like(rmx)
    for _ in range(cand_k - 1):
        cx_ = noise.uniform_in(f['obj_min_x'], f['obj_span_x'])
        cy_ = noise.uniform_in(f['obj_min_y'], f['obj_span_y'])
        ddx, ddy = cx_ - rmx, cy_ - rmy
        ok = torch.sqrt(ddx * ddx + ddy * ddy) > f['min_mo']
        take = ok & (found == 0.0)
        trials = trials + (1.0 - found)
        rox = torch.where(take, cx_, rox)
        roy = torch.where(take, cy_, roy)
        found = torch.maximum(found, torch.where(ok, 1.0, 0.0))
    rgx = noise.uniform_in(f['obj_min_x'], f['obj_span_x'])
    rgy = noise.uniform_in(f['obj_min_y'], f['obj_span_y'])
    return rmx, rmy, rox, roy, found, trials, rgx, rgy


def _normals_plain(noise: UniformStream, pairs: int) -> tuple:
    return tuple(z for _ in range(pairs) for z in noise.normal_pair())


def step_draws_plain(kc: KernelConsts, noise: UniformStream) -> StepDraws:
    """One autoreset step's ``StepDraws``, consuming its
    ``autoreset_noise_planes`` uniforms in order."""
    f = kc.f
    cycles = cycle_draws_plain(f, noise, kc.num_cycles, kc.box)
    n = _normals_plain(noise, 3)
    restart = restart_plain(f, noise, kc.cand_k)
    return StepDraws(cycles=cycles, n=n, restart=restart, m=_normals_plain(noise, 3))


def autoreset_physics_plain(kc: KernelConsts, draws: StepDraws, st, ux, uy):
    """``_pushing_autoreset_step`` on the step's ``draws``: 19 state planes
    in; returns the 19 new state planes and the 19 aux planes (s_obs 6,
    f_obs 8, wall, reached, trunc, stalled, trials)."""
    f = kc.f
    phys, (gx, gy, steps) = st[:16], st[16:19]
    g_old_x, g_old_y = gx, gy
    phys, wall_f = _run_cycles_plain(f, draws.cycles, kc.learn_jerk, kc.box, phys, ux, uy)
    px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz = phys
    f_qax, f_qay = ax, ay

    n1, n2, n3, n4, n5, n6 = draws.n
    f_mpx = px + n1 * f['std_pos']
    f_mpy = py + n2 * f['std_pos']
    f_mvx = vx + n3 * f['std_vel']
    f_mvy = vy + n4 * f['std_vel']
    f_agx = ox + n5 * f['object_noise']
    f_agy = oy + n6 * f['object_noise']

    term = wall_f > 0.0
    new_steps = steps + 1.0
    trunc = new_steps >= f['max_episode_steps']
    done = term | trunc

    rmx, rmy, rox, roy, found, trials, rgx, rgy = draws.restart
    # a stalled restart keeps the post-cycle state and the incremented counter
    stalled_f = torch.where(done & (found == 0.0), 1.0, 0.0)
    do_reset = done & (found > 0.0)

    def reset_to(new, old):
        return torch.where(do_reset, new, old)

    px, py = reset_to(rmx, px), reset_to(rmy, py)
    vx, vy, ax, ay, kx, ky = (reset_to(0.0, x) for x in (vx, vy, ax, ay, kx, ky))
    ox, oy = reset_to(rox, ox), reset_to(roy, oy)
    wvx, wvy, oyaw, ow = (reset_to(0.0, x) for x in (wvx, wvy, oyaw, ow))
    mz = reset_to(f['z0'], mz)
    mvz = reset_to(0.0, mvz)
    gx, gy = reset_to(rgx, gx), reset_to(rgy, gy)
    steps = reset_to(0.0, new_steps)

    m1, m2, m3, m4, m5, m6 = draws.m
    s_mpx = reset_to(px + m1 * f['std_pos'], f_mpx)
    s_mpy = reset_to(py + m2 * f['std_pos'], f_mpy)
    s_mvx = reset_to(vx + m3 * f['std_vel'], f_mvx)
    s_mvy = reset_to(vy + m4 * f['std_vel'], f_mvy)
    s_agx = reset_to(ox + m5 * f['object_noise'], f_agx)
    s_agy = reset_to(oy + m6 * f['object_noise'], f_agy)

    ddx_g, ddy_g = f_agx - g_old_x, f_agy - g_old_y
    reached = torch.sqrt(ddx_g * ddx_g + ddy_g * ddy_g) <= f['threshold']

    new_st = [px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz, gx, gy, steps]
    aux = [
        s_mpx, s_mpy, s_mvx, s_mvy, s_agx, s_agy,
        f_mpx, f_mpy, f_mvx, f_mvy, f_agx, f_agy, f_qax, f_qay,
        wall_f, torch.where(reached, 1.0, 0.0), torch.where(trunc, 1.0, 0.0),
        stalled_f, torch.where(done, trials, 0.0),
    ]
    return new_st, aux


def _autoreset_step_plain(kc: KernelConsts, noise: UniformStream, st, ux, uy):
    """``_pushing_autoreset_step``: the step's draws, then its physics."""
    return autoreset_physics_plain(kc, step_draws_plain(kc, noise), st, ux, uy)


def pushing_cycles_plain(planes: torch.Tensor, kc: KernelConsts, uniforms: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: ``[18, B]`` (16 physics + action x/y) ->
    ``[17, B]`` (16 physics + wall) over ``[cycles_noise_planes, B]`` uniforms."""
    noise = UniformStream(uniforms)
    draws = cycle_draws_plain(kc.f, noise, kc.num_cycles, kc.box)
    phys, wall = _run_cycles_plain(kc.f, draws, kc.learn_jerk, kc.box, list(planes[:16]), planes[16], planes[17])
    noise.finalize()
    return torch.stack(phys + [wall])


def feature_block(mpx, mpy, mvx, mvy, agx, agy, gx, gy) -> torch.Tensor:
    """One ``[12, B]`` policy feature block, the training recipes' layout
    (``tools/transfer_eval._pushing_vec``): mover position and velocity,
    achieved, goal, achieved - mover, goal - achieved."""
    return torch.stack([mpx, mpy, mvx, mvy, agx, agy, gx, gy, agx - mpx, agy - mpy, gx - agx, gy - agy])


def features_from_planes(state: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """C-feat's ``[2, 12, B]`` feature blocks from kernel C's input state
    ``[19, B]`` and its 36 output planes: block 0 the post-reset observation
    with the (possibly new) goal, block 1 the pre-reset observation with the
    goal the step started from (``pallas_step.py:1073-1078``)."""
    post = feature_block(*out[19:25], out[16], out[17])
    pre = feature_block(*out[25:31], state[16], state[17])
    return torch.stack([post, pre])


def pushing_autoreset_plain(state: torch.Tensor, action: torch.Tensor, kc: KernelConsts,
                            uniforms: torch.Tensor, emit_features: bool = False):
    """Plain version of kernel C: ``[19, B]`` state + ``[2, B]`` action ->
    the 36 output planes ``[36, B]``; with ``emit_features`` (C-feat) also
    the ``[2, 12, B]`` feature blocks (``features_from_planes``)."""
    noise = UniformStream(uniforms)
    new_st, aux = _autoreset_step_plain(kc, noise, list(state), action[0], action[1])
    noise.finalize()
    out = torch.stack(new_st + aux[:15] + aux[17:])
    return (out, features_from_planes(state, out)) if emit_features else out


def pushing_rollout_plain(state: torch.Tensor, actions: torch.Tensor, kc: KernelConsts,
                          uniforms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel D: ``[19, B]`` state + ``[K, 2, B]`` actions ->
    (final ``[19, B]`` state, ``[3, K, B]`` wall/reached/trunc) over
    ``[K * autoreset_noise_planes, B]`` uniforms."""
    noise = UniformStream(uniforms)
    st = list(state)
    signals = []
    for t in range(actions.shape[0]):
        st, aux = _autoreset_step_plain(kc, noise, st, actions[t, 0], actions[t, 1])
        signals.append(torch.stack(aux[14:17]))
    noise.finalize()
    return torch.stack(st), torch.stack(signals, dim=1)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _consts_ptr(kc: KernelConsts) -> int:
    names = build.lib().const_names
    if names != CONST_FIELDS:
        raise RuntimeError(f'gprt::Consts field order differs from CONST_FIELDS: {names}')
    return kc.vector.ctypes.data


#: the widest batch for which each pushing kernel launches blocks with the
#: producer warp, by collision shape: shape -> {kernel: envs}, the kernels
#: B (``cycles``), C and C-feat (``autoreset``) and D (``rollout``).  Up to
#: it the card is latency-bound and the producer takes the draws off each
#: consumer's chain; above it, where the issue rate binds, blocks whose
#: every warp draws its own values are faster.  B's circle, whose draws are
#: the smallest share of its chain, crosses first (measured on the card:
#: PERF.md section 6)
WIDE_BATCH = {
    'circle': {'cycles': 8192, 'autoreset': 32768, 'rollout': 32768},
    'box': {'cycles': 32768, 'autoreset': 32768, 'rollout': 32768},
}


def uses_producer(b: int, kc: KernelConsts, kernel: str = 'autoreset') -> int:
    """1 if a launch of ``kernel`` (``'cycles'``: B, ``'autoreset'``: C and
    C-feat, ``'rollout'``: D) over ``b`` envs in ``kc``'s collision shape
    runs blocks with the producer warp, up to its wide batch; else 0, blocks
    whose every warp draws its own values."""
    return int(b <= WIDE_BATCH['box' if kc.box else 'circle'][kernel])


def pushing_cycles_cuda(planes, kc: KernelConsts, uniforms=None, seed: int | torch.Tensor = 0) -> torch.Tensor:
    """Kernel B on the card (``seed``: ``kernels.seed_args``)."""
    b = planes.shape[1]
    kernels.check_plane(planes, 'planes', (18, b))
    noise_ptr = kernels.noise_ptr(uniforms, cycles_noise_planes(kc.num_cycles, kc.box), b, planes.device)
    out = torch.empty((17, b), dtype=torch.float32, device=planes.device)
    with torch.cuda.device(planes.device):
        err = build.lib().gprt_pushing_cycles(
            planes.data_ptr(), noise_ptr, out.data_ptr(), b, _consts_ptr(kc), kc.num_cycles,
            int(kc.learn_jerk), int(kc.box), *kernels.seed_args(seed, planes.device),
            uses_producer(b, kc, 'cycles'), kernels.stream_ptr(out),
        )
    name = launch_name('pushing_cycles', kc)
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


def split_layout() -> dict:
    """Kernels B, C and D's ring layout as the built library has it (ring
    slots, values per stage, cycles per stage of each shape)."""
    text = build.lib().gprt_split_layout().decode()
    return {k: int(v) for k, v in (f.split('=') for f in text.split(','))}


def pushing_autoreset_cuda(state, action, kc: KernelConsts, uniforms=None, seed: int | torch.Tensor = 0,
                           emit_features: bool = False):
    """Kernel C on the card; with ``emit_features`` its C-feat variant,
    which also writes the ``[2, 12, B]`` feature blocks and counts under its
    own ``LAUNCHES`` key."""
    b = state.shape[1]
    kernels.check_plane(state, 'state', (N_STATE, b))
    kernels.check_plane(action, 'action', (2, b))
    n_noise = autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    noise_ptr = kernels.noise_ptr(uniforms, n_noise, b, state.device)
    out = torch.empty((N_AUTORESET_OUT, b), dtype=torch.float32, device=state.device)
    feat = torch.empty((2, N_FEATURES, b), dtype=torch.float32, device=state.device) if emit_features else None
    with torch.cuda.device(state.device):
        err = build.lib().gprt_pushing_autoreset(
            state.data_ptr(), action.data_ptr(), noise_ptr, out.data_ptr(), feat.data_ptr() if emit_features else None,
            b, _consts_ptr(kc), kc.num_cycles, kc.cand_k, int(kc.learn_jerk), int(kc.box),
            *kernels.seed_args(seed, state.device), uses_producer(b, kc), kernels.stream_ptr(out),
        )
    name = launch_name('pushing_autoreset_features' if emit_features else 'pushing_autoreset', kc)
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return (out, feat) if emit_features else out


def pushing_rollout_cuda(state, actions, kc: KernelConsts, uniforms=None, seed: int | torch.Tensor = 0):
    """Kernel D on the card."""
    b = state.shape[1]
    k = actions.shape[0]
    kernels.check_plane(state, 'state', (N_STATE, b))
    kernels.check_plane(actions, 'actions', (k, 2, b))
    n_noise = k * autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    noise_ptr = kernels.noise_ptr(uniforms, n_noise, b, state.device)
    st_out = torch.empty((N_STATE, b), dtype=torch.float32, device=state.device)
    step_out = torch.empty((3, k, b), dtype=torch.float32, device=state.device)
    with torch.cuda.device(state.device):
        err = build.lib().gprt_pushing_rollout(
            state.data_ptr(), actions.data_ptr(), noise_ptr, st_out.data_ptr(), step_out.data_ptr(), b, k,
            _consts_ptr(kc), kc.num_cycles, kc.cand_k, int(kc.learn_jerk), int(kc.box),
            *kernels.seed_args(seed, state.device), uses_producer(b, kc, 'rollout'), kernels.stream_ptr(st_out),
        )
    name = launch_name('pushing_rollout', kc)
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return st_out, step_out


# ---------------------------------------------------------------------------
# dispatch: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------


def pushing_cycles(planes, kc: KernelConsts, *, uniforms=None, seed: int | None = None, generator=None):
    """Kernel B, or its plain version on CPU tensors (``kernels.dispatch``)."""
    return kernels.dispatch((planes,), cycles_noise_planes(kc.num_cycles, kc.box), uniforms, seed, generator,
                            lambda u: pushing_cycles_plain(planes, kc, u),
                            lambda u, s: pushing_cycles_cuda(planes, kc, u, s))


def pushing_autoreset(state, action, kc: KernelConsts, *, uniforms=None, seed: int | None = None, generator=None,
                      emit_features: bool = False):
    """Kernel C, or its plain version on CPU tensors: ``out [36, B]``, or
    ``(out, feat [2, 12, B])`` with ``emit_features`` (C-feat)."""
    return kernels.dispatch((state, action), autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box), uniforms, seed,
                            generator, lambda u: pushing_autoreset_plain(state, action, kc, u, emit_features),
                            lambda u, s: pushing_autoreset_cuda(state, action, kc, u, s, emit_features))


def pushing_rollout(state, actions, kc: KernelConsts, *, uniforms=None, seed: int | None = None, generator=None):
    """Kernel D, or its plain version on CPU tensors."""
    n = actions.shape[0] * autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    return kernels.dispatch((state, actions), n, uniforms, seed, generator,
                            lambda u: pushing_rollout_plain(state, actions, kc, u),
                            lambda u, s: pushing_rollout_cuda(state, actions, kc, u, s))
