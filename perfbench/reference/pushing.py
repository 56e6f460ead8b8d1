"""Plain PyTorch reference of BenchmarkPushingEnv's fused autoreset step.

One env step of the JAX package's semantics, as the program's fused
kernels C, C-feat and D are to compute it: ``num_cycles`` control cycles
(noisy velocity reading, the velocity clamp, the corner-aware penalty
contact with the object, the mover's height, the object's floor friction
and spin, the noisy wall check of the full 3x3 table; each env frozen from
the cycle its wall check fires), the pre-reset observation, termination
and truncation, the in-kernel restart (the mover uniform, the object the
first of ``cand_k`` candidates farther than ``min_mo`` from it, the goal
uniform) and the post-reset observation; every operation rounded on its
own, the draws in the kernels' order.

Frozen from the program's plain versions of its kernels; it reads every
constant from the configuration's file and nothing from the program.  The
circle collision shape in acceleration mode on the full table is all it
covers: ``constants`` refuses any other configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.noise import Replay, Stream, launch_uniforms, sqrt

REWARD_WALL = -50.0


def _f32(x) -> float:
    return float(np.float32(x))


def noise_planes(num_cycles: int, cand_k: int) -> int:
    """Uniforms one step draws: per cycle a velocity pair and the wall
    check's pair; the pre-reset observation (3 pairs); the restart (mover
    2, object 2 * cand_k, goal 2); the post-reset observation (3 pairs)."""
    return 4 * num_cycles + 16 + 2 * cand_k


def constants(cfg: dict) -> dict:
    """The step's f32 constants, formed from the configuration's numbers as
    the JAX package forms them (float64 where it uses Python floats, float32
    where it uses arrays), each rounded once to f32."""
    env, c = cfg['env'], cfg['constants']
    if cfg['collision_shape'] != 'circle' or env['learn_jerk'] or not np.asarray(cfg['layout']).all():
        raise NotImplementedError('the reference covers the circle shape in acceleration mode on a full table')
    t = np.float32
    tsx, tsy = (float(t(v)) for v in cfg['tile_half_size'][:2])
    nx, ny = np.asarray(cfg['layout']).shape
    tile = [float(t((2 * i + 1) * cfg['tile_half_size'][0])) for i in range(nx)]
    tile_y = [float(t((2 * j + 1) * cfg['tile_half_size'][1])) for j in range(ny)]
    obj_half = c['object_size'] / 2
    mover_half = np.asarray(c['mover_half_size'], np.float64)
    r = env['collision_size']
    margin = r + env['collision_offset'] + env['collision_offset_wall']
    reach = float(np.linalg.norm(obj_half + mover_half[:2]))
    min_mo = max(reach, r + env['collision_offset'])
    hi = 5 * cfg['tile_half_size'][0] + cfg['tile_half_size'][0] / 2
    obj_mass, gravity, dt = t(c['object_mass']), t(c['gravity']), t(c['dt'])
    mover_mass = c['mover_mass']
    obj_inertia = t(c['object_mass'] * (obj_half ** 2 + obj_half ** 2) / 3.0)
    v = dict(
        v_max=env['v_max'], a_max=env['a_max'], dt=float(dt),
        std_pos=_f32(env['std_noise']), std_vel=_f32(env['std_noise']),
        accel_scale=1.0, total_mass=_f32(mover_mass),
        mover_hx=_f32(mover_half[0]), mover_hy=_f32(mover_half[1]), obj_hx=_f32(obj_half), obj_hy=_f32(obj_half),
        obj_mass=float(obj_mass), contact_k=_f32(c['contact_k']),
        contact_b=_f32(2.0 * np.sqrt(c['contact_k'] * c['object_mass'])),
        contact_bt=_f32(c['contact_bt']), contact_mu=_f32(c['contact_mu']),
        mu_g_dt=float(t(c['floor_mu']) * gravity * dt), obj_inertia=float(obj_inertia),
        plow_unit=float(t(c['plow_kappa']) / (obj_mass * gravity)), plow_cap=_f32(c['plow_cap']),
        cone_zeta=_f32(c['cone_zeta']), cone_vt=_f32(c['cone_vt']),
        cone_vt_off=_f32(c['cone_vt_off']), cone_vt_span=_f32(c['cone_vt_off']) - _f32(c['cone_vt_hi']),
        conez_unit=float(t(c['cone_plow']) / (obj_mass * gravity)), conez_cap=_f32(c['cone_plow_cap']),
        mover_height=_f32(2.0 * mover_half[2]), obj_height=_f32(c['object_height']),
        imp_k=_f32(c['imp_k']), imp_d=_f32(2.0 * np.sqrt(c['imp_k'] * mover_mass)),
        z0=_f32(env['initial_mover_zpos']), fz_cap0=_f32(c['cone_fz_cap']), fz_slope=_f32(c['cone_fz_slope']),
        damp=1.0 + float(dt) * _f32(c['object_damping']) / float(obj_mass),
        damp_w=1.0 + float(dt) * _f32(c['object_damping']) / float(obj_inertia),
        mu_spin_dt=_f32(c['mu_spin']) * float(dt),
        wall_x=_f32(r) + env['collision_offset_wall'],
        x0=tile[0] - tsx, x1=tile[-1] + tsx, y0=tile_y[0] - tsy, y1=tile_y[-1] + tsy,
        fx0=tile[1] - tsx, fx1=tile[-2] + tsx, fy0=tile_y[1] - tsy, fy1=tile_y[-2] + tsy,
        object_noise=_f32(c['object_noise']), max_episode_steps=float(env['max_episode_steps']),
        min_x=_f32(margin), min_y=_f32(margin), span_x=_f32(hi - margin) - _f32(margin),
        span_y=_f32(hi - margin) - _f32(margin),
        obj_min_x=_f32(2 * margin), obj_min_y=_f32(2 * margin),
        obj_span_x=_f32(hi - 2 * margin) - _f32(2 * margin), obj_span_y=_f32(hi - 2 * margin) - _f32(2 * margin),
        min_mo=_f32(min_mo), threshold=_f32(env['threshold_pos']),
    )
    return {k: _f32(x) for k, x in v.items()}


def _wall_ok(f, px, py):
    """Full-table rule for the circle: the centre above the interior, or
    above the table with the circle strictly inside its outer edge."""
    r = f['wall_x']
    fast = (px >= f['fx0']) & (px <= f['fx1']) & (py >= f['fy0']) & (py <= f['fy1'])
    above = (px >= f['x0']) & (px <= f['x1']) & (py >= f['y0']) & (py <= f['y1'])
    inside = (px - r > f['x0']) & (px + r < f['x1']) & (py - r > f['y0']) & (py + r < f['y1'])
    return fast | (above & inside)


def _cycles(f: dict, num_cycles: int, noise: Stream, phys: list, ux, uy):
    """The cycle loop: 16 physics planes in, 16 out and the wall flag."""
    px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz = phys
    draws = [(noise.normal_pair(), noise.normal_pair()) for _ in range(num_cycles)]
    dt = f['dt']
    dt_t = torch.full((), dt, dtype=torch.float32, device=px.device)
    done_f = torch.zeros_like(px)
    wall_f = torch.zeros_like(px)
    caxis = torch.full_like(px, -1.0)
    for (nvx, nvy), (nwx, nwy) in draws:
        done = done_f > 0.0
        vmx = vx + nvx * f['std_vel']
        vmy = vy + nvy * f['std_vel']
        # the velocity clamp: the raw action unless the clamp fires
        bx, by = vmx + dt * ux, vmy + dt * uy
        norm = sqrt(bx * bx + by * by)
        vclamp = norm >= f['v_max']
        safe = torch.where(norm > 0, norm, 1.0)
        cnx, cny = f['v_max'] * bx / safe, f['v_max'] * by / safe
        ctrl_x = torch.where(vclamp, (cnx - vmx) / dt_t, ux)
        ctrl_y = torch.where(vclamp, (cny - vmy) / dt_t, uy)

        cos_y, sin_y = torch.cos(oyaw), torch.sin(oyaw)
        rx = torch.abs(cos_y) * f['obj_hx'] + torch.abs(sin_y) * f['obj_hy']
        ry = torch.abs(sin_y) * f['obj_hx'] + torch.abs(cos_y) * f['obj_hy']
        dx_, dy_ = ox - px, oy - py
        olx = (f['mover_hx'] + rx) - torch.abs(dx_)
        oly = (f['mover_hy'] + ry) - torch.abs(dy_)
        in_contact = (olx > 0) & (oly > 0)
        olx_c, oly_c = torch.clamp(olx, min=0.0), torch.clamp(oly, min=0.0)
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
        r_ox = 0.5 * (lo_x + hi_x) - ox
        r_oy = 0.5 * (lo_y + hi_y) - oy
        vrx = (wvx - ow * r_oy) - vx
        vry = (wvy + ow * r_ox) - vy
        vn = vrx * n_x + vry * n_y
        fn_mag = torch.clamp(f['contact_k'] * pen - f['contact_b'] * vn, min=0.0)
        t_x, t_y = -n_y, n_x
        vt = vrx * t_x + vry * t_y
        f_imp_r = torch.minimum(torch.clamp(-f['contact_b'] * vn, min=0.0), fn_mag)
        avt = torch.abs(vt)
        slip = torch.clamp(avt / f['cone_vt'], max=1.0) * torch.clamp(
            (f['cone_vt_off'] - avt) / f['cone_vt_span'], 0.0, 1.0)
        fz_cap = f['fz_cap0'] + f['fz_slope'] * torch.clamp(mz - f['z0'], min=0.0)
        f_z = torch.minimum(f['cone_zeta'] * fn_mag * slip, fz_cap)
        budget = f['contact_mu'] * fn_mag
        cap = torch.where(f_z > 0, torch.sqrt(torch.clamp(budget * budget - f_z * f_z, min=0.0)), budget)
        ft_mag = torch.clamp(-f['contact_bt'] * vt, -cap, cap)
        cmask = torch.where(in_contact, 1.0, 0.0)
        zf = torch.clamp((torch.clamp(mz + f['mover_height'], max=f['obj_height']) - mz) / f['mover_height'],
                         0.0, 1.0)
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
        ovx_t, ovy_t = ovx_t * scale, ovy_t * scale
        nox, noy = ox + dt * ovx_t, oy + dt * ovy_t
        ow_t = (ow + dt * torque / f['obj_inertia']) / f['damp_w']
        ow_t = torch.sign(ow_t) * torch.clamp(torch.abs(ow_t) - f['mu_spin_dt'] * load, min=0.0)
        noyaw = oyaw + dt * ow_t

        sp = f['std_pos']
        new_wall_f = torch.where(_wall_ok(f, npx + nwx * sp, npy + nwy * sp), 0.0, 1.0)

        def keep(old, new):
            return torch.where(done, old, new)

        px, py, vx, vy = keep(px, npx), keep(py, npy), keep(vx, nvx_t), keep(vy, nvy_t)
        ax, ay = keep(ax, qacc_x), keep(ay, qacc_y)
        ox, oy, wvx, wvy = keep(ox, nox), keep(oy, noy), keep(wvx, ovx_t), keep(wvy, ovy_t)
        oyaw, ow, mz, mvz = keep(oyaw, noyaw), keep(ow, ow_t), keep(mz, new_mz), keep(mvz, new_mvz)
        caxis = keep(caxis, torch.where(zf > 0, new_caxis, -1.0))
        wall_f = keep(wall_f, new_wall_f)
        done_f = torch.maximum(done_f, wall_f)
    return [px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz], wall_f


def _pairs(noise: Stream, n: int) -> tuple:
    return tuple(z for _ in range(n) for z in noise.normal_pair())


def _restart(f: dict, noise: Stream, cand_k: int):
    rmx = noise.uniform_in(f['min_x'], f['span_x'])
    rmy = noise.uniform_in(f['min_y'], f['span_y'])
    rox = noise.uniform_in(f['obj_min_x'], f['obj_span_x'])
    roy = noise.uniform_in(f['obj_min_y'], f['obj_span_y'])
    d0x, d0y = rox - rmx, roy - rmy
    found = torch.where(torch.sqrt(d0x * d0x + d0y * d0y) > f['min_mo'], 1.0, 0.0)
    for _ in range(cand_k - 1):
        cx_ = noise.uniform_in(f['obj_min_x'], f['obj_span_x'])
        cy_ = noise.uniform_in(f['obj_min_y'], f['obj_span_y'])
        ddx, ddy = cx_ - rmx, cy_ - rmy
        ok = torch.sqrt(ddx * ddx + ddy * ddy) > f['min_mo']
        take = ok & (found == 0.0)
        rox, roy = torch.where(take, cx_, rox), torch.where(take, cy_, roy)
        found = torch.maximum(found, torch.where(ok, 1.0, 0.0))
    rgx = noise.uniform_in(f['obj_min_x'], f['obj_span_x'])
    rgy = noise.uniform_in(f['obj_min_y'], f['obj_span_y'])
    return rmx, rmy, rox, roy, found, rgx, rgy


def step(f: dict, num_cycles: int, cand_k: int, uniforms: torch.Tensor, st: list, ux, uy):
    """One autoreset step: 19 state planes in; returns the 19 new planes,
    the wall and reached flags, and the two ``[12, B]`` feature blocks
    (post-reset observation with the new goal, pre-reset observation with
    the goal the step started from)."""
    noise = Stream(uniforms)
    phys, (gx, gy, steps) = st[:16], st[16:19]
    phys, wall_f = _cycles(f, num_cycles, noise, phys, ux, uy)
    px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz = phys
    n1, n2, n3, n4, n5, n6 = _pairs(noise, 3)
    f_mpx, f_mpy = px + n1 * f['std_pos'], py + n2 * f['std_pos']
    f_mvx, f_mvy = vx + n3 * f['std_vel'], vy + n4 * f['std_vel']
    f_agx, f_agy = ox + n5 * f['object_noise'], oy + n6 * f['object_noise']
    rmx, rmy, rox, roy, found, rgx, rgy = _restart(f, noise, cand_k)
    m1, m2, m3, m4, m5, m6 = _pairs(noise, 3)
    noise.done()

    new_steps = steps + 1.0
    done = (wall_f > 0.0) | (new_steps >= f['max_episode_steps'])
    do_reset = done & (found > 0.0)

    def reset_to(new, old):
        return torch.where(do_reset, new, old)

    px, py = reset_to(rmx, px), reset_to(rmy, py)
    vx, vy, ax, ay, kx, ky = (reset_to(0.0, x) for x in (vx, vy, ax, ay, kx, ky))
    ox, oy = reset_to(rox, ox), reset_to(roy, oy)
    wvx, wvy, oyaw, ow = (reset_to(0.0, x) for x in (wvx, wvy, oyaw, ow))
    mz, mvz = reset_to(f['z0'], mz), reset_to(0.0, mvz)
    ngx, ngy = reset_to(rgx, gx), reset_to(rgy, gy)
    steps = reset_to(0.0, new_steps)
    s_mpx = reset_to(px + m1 * f['std_pos'], f_mpx)
    s_mpy = reset_to(py + m2 * f['std_pos'], f_mpy)
    s_mvx = reset_to(vx + m3 * f['std_vel'], f_mvx)
    s_mvy = reset_to(vy + m4 * f['std_vel'], f_mvy)
    s_agx = reset_to(ox + m5 * f['object_noise'], f_agx)
    s_agy = reset_to(oy + m6 * f['object_noise'], f_agy)
    ddx, ddy = f_agx - gx, f_agy - gy
    reached = torch.sqrt(ddx * ddx + ddy * ddy) <= f['threshold']
    new_st = [px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz, ngx, ngy, steps]
    post = features(s_mpx, s_mpy, s_mvx, s_mvy, s_agx, s_agy, ngx, ngy)
    pre = features(f_mpx, f_mpy, f_mvx, f_mvy, f_agx, f_agy, gx, gy)
    return new_st, wall_f > 0.0, reached, torch.stack([post, pre])


def features(mpx, mpy, mvx, mvy, agx, agy, gx, gy) -> torch.Tensor:
    """The policy's 12 features: mover position and velocity, achieved,
    goal, achieved - mover, goal - achieved."""
    return torch.stack([mpx, mpy, mvx, mvy, agx, agy, gx, gy, agx - mpx, agy - mpy, gx - agx, gy - agy])


def signals(f: dict, steps_in, wall, reached) -> tuple:
    """A step's reward (-50 on a wall hit, 0 at the goal, else -1),
    termination and truncation."""
    reward = torch.where(wall, REWARD_WALL, torch.where(reached, 0.0, -1.0))
    return reward, wall, steps_in + 1.0 >= f['max_episode_steps']


def work(cfg: dict, batch: int = 4) -> dict:
    """One env step in parts, for ``opcount``: ``{name: (fn, inputs)}``.
    ``step``: a rollout's step with its signals; ``step_features``: the
    same handing on the feature blocks too; ``cycles_<n>``: ``n`` control
    cycles; ``restart_<k>``: the restart with ``k`` object candidates."""
    f, env = constants(cfg), cfg['env']
    num_cycles, cand_k = env['num_cycles'], cfg['cand_k']
    st = torch.zeros((19, batch))
    ux = uy = torch.zeros(batch)

    def one_step(blocks):
        def fn(st, u, ux, uy):
            new_st, wall, reached, blk = step(f, num_cycles, cand_k, u, list(st), ux, uy)
            out = [torch.stack(new_st), *signals(f, st[18], wall, reached)]
            return out + [blk] if blocks else out
        return fn, (st, torch.rand((noise_planes(num_cycles, cand_k), batch)), ux, uy)

    def cycles(n):
        return (lambda st, u, ux, uy: _cycles(f, n, Stream(u), list(st[:16]), ux, uy),
                (st, torch.rand((4 * n, batch)), ux, uy))

    def restart(k):
        return lambda u: _restart(f, Stream(u), k), (torch.rand((2 * k + 4, batch)),)

    return {'step': one_step(False), 'step_features': one_step(True), 'cycles_1': cycles(1),
            'cycles_2': cycles(2), 'restart_1': restart(1), f'restart_{cand_k}': restart(cand_k)}


def state_planes(state) -> torch.Tensor:
    """The 19 f32 planes of a pushing state's fields (positions, velocities,
    accelerations, activations, the object's position and velocity, its yaw
    and spin, the mover's height and vertical speed, the goal, the step)."""
    cols = []
    for name in ('pos', 'vel', 'acc', 'act', 'obj_pos', 'obj_vel'):
        arr = getattr(state, name)
        cols += [arr[:, 0], arr[:, 1]]
    cols += [state.obj_yaw, state.obj_w, state.mover_z, state.mover_vz, state.goal[:, 0], state.goal[:, 1],
             state.steps]
    return torch.stack([c.to(torch.float32) for c in cols])


def rollout(cfg: dict, planes: torch.Tensor, actions: torch.Tensor, seed: int, steps_per_launch: int,
            dtype=torch.float32, features_out: bool = False):
    """``T`` steps from the 19 state planes with actions ``[T, B, 2]``
    (clamped to the action limit here), launch ``c`` keyed by ``seed + c``
    over its ``steps_per_launch`` steps.  Returns ``(planes [19, B], reward
    [T, B], terminated [T, B], truncated [T, B], blocks [T, 2, 12, B] or
    None)`` in ``dtype`` (float32, or the control's lower precision)."""
    f, env = constants(cfg), cfg['env']
    num_cycles, cand_k = env['num_cycles'], cfg['cand_k']
    per = noise_planes(num_cycles, cand_k)
    b, device = planes.shape[1], planes.device
    lim = f['a_max']
    acts = torch.clamp(actions.to(torch.float32).reshape(-1, b, 2), -lim, lim).to(dtype)
    st = planes.to(dtype)

    def one_step(s, ux, uy, u):
        new_st, wall, reached, blk = step(f, num_cycles, cand_k, u, list(s), ux, uy)
        return torch.stack(new_st), wall, reached, blk

    one = Replay(one_step, [st, acts[0, :, 0], acts[0, :, 1], torch.zeros((per, b), dtype=dtype, device=device)])
    rew, term, trunc, blocks = [], [], [], []
    n_steps = acts.shape[0]
    for t0 in range(0, n_steps, steps_per_launch):
        k = min(steps_per_launch, n_steps - t0)
        u = launch_uniforms(seed + t0 // steps_per_launch, k * per, b, device).to(dtype)
        for j in range(k):
            t = t0 + j
            steps_in = st[18]
            st, wall, reached, blk = (x.clone() for x in one(st, acts[t, :, 0], acts[t, :, 1],
                                                              u[j * per:(j + 1) * per]))
            for out, x in zip((rew, term, trunc), signals(f, steps_in, wall, reached)):
                out.append(x)
            if features_out:
                blocks.append(blk)
    return (st, torch.stack(rew), torch.stack(term), torch.stack(trunc),
            torch.stack(blocks) if features_out else None)


def start_invalid(cfg: dict, state, stalled: torch.Tensor) -> int:
    """Envs of a freshly reset batch that break the configuration's start
    rules: the mover, the object and the goal inside their sampling boxes,
    the object farther than ``min_mo`` from the mover (where the reset did
    not report a stall), everything at rest at the hover height, the step
    counter at 0."""
    f = constants(cfg)
    eps = 1e-6

    def within(xy, lo_x, lo_y, span_x, span_y):
        x, y = xy[:, 0], xy[:, 1]
        return ((x >= lo_x - eps) & (x <= lo_x + span_x + eps) & (y >= lo_y - eps) & (y <= lo_y + span_y + eps))

    ok = within(state.pos, f['min_x'], f['min_y'], f['span_x'], f['span_y'])
    ok &= within(state.obj_pos, f['obj_min_x'], f['obj_min_y'], f['obj_span_x'], f['obj_span_y'])
    ok &= within(state.goal, f['obj_min_x'], f['obj_min_y'], f['obj_span_x'], f['obj_span_y'])
    d = state.obj_pos.to(torch.float32) - state.pos.to(torch.float32)
    ok &= (torch.sqrt((d * d).sum(-1)) > f['min_mo'] - eps) | stalled
    for name in ('vel', 'acc', 'act', 'obj_vel'):
        ok &= (getattr(state, name) == 0).all(-1)
    for name in ('obj_yaw', 'obj_w', 'mover_vz', 'steps'):
        ok &= getattr(state, name) == 0
    ok &= (state.mover_z - f['z0']).abs() <= eps
    return int((~ok).sum())
