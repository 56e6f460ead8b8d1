"""Plain PyTorch reference of M-mover BenchmarkPlanningEnv's fused autoreset step.

One env step of the JAX package's semantics, as the program's kernel H is
to compute it: ``num_cycles`` control cycles of every mover (noisy velocity
reading, the velocity clamp, the integration, the noisy wall check of the
full table, the noisy pair test of every pair of movers; the env frozen
from the cycle any check fires, the shared fate), the pre-reset
observation and the goal test, termination and truncation, the restart
(the first of ``cand_k`` start sets and of ``cand_k`` goal sets that pass
their tests; a stalled restart leaves the env as it is) and the post-reset
observation; every operation rounded on its own, the draws in the kernel's
order.

Frozen from the program's plain version of kernel H, with the movers and
the candidate sets as an axis of their own where the plain version loops
over them: the same operations element by element.  It reads every
constant from the configuration's file and nothing from the program.  The
circle collision shape in acceleration mode on a full table with equal
movers is all it covers.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.noise import TWO_PI, Replay, Stream, launch_uniforms, sqrt

REWARD_SUCCESS = 50.0


def _f32(x) -> float:
    return float(np.float32(x))


def noise_planes(num_cycles: int, m: int, cand_k: int) -> int:
    """Uniforms one step draws: per cycle and mover a velocity pair, the
    wall check's pair and the pair test's pair; the pre- and post-reset
    observations (2 pairs a mover each); cand_k start and cand_k goal sets
    of M positions."""
    return 6 * m * num_cycles + 8 * m + 4 * m * cand_k


def constants(cfg: dict) -> dict:
    """The step's f32 constants from the configuration's numbers, formed as
    the JAX package forms them (float64 sums, one rounding to f32)."""
    env = cfg['env']
    layout = np.asarray(cfg['layout'])
    if cfg['collision_shape'] != 'circle' or env['learn_jerk'] or not layout.all():
        raise NotImplementedError('the reference covers the circle shape in acceleration mode on a full table')
    t = np.float32
    half = cfg['tile_half_size']
    tsx, tsy = _f32(half[0]), _f32(half[1])
    nx, ny = layout.shape
    tile = [_f32((2 * i + 1) * half[0]) for i in range(nx)]
    tile_y = [_f32((2 * j + 1) * half[1]) for j in range(ny)]
    c = _f32(env['collision_size'])  # the size as the program holds it, in float64
    off, offw = env['collision_offset'], env['collision_offset_wall']
    margin = env['collision_size'] + off + offw
    hi_x = (2 * nx - 1) * half[0] + half[0] / 2
    hi_y = (2 * ny - 1) * half[1] + half[1] / 2
    min_x, min_y = _f32(margin), _f32(margin)
    v = dict(
        v_max=env['v_max'], a_max=env['a_max'], dt=_f32(0.001), std_pos=_f32(env['std_noise']),
        std_vel=_f32(env['std_noise']), x0=tile[0] - tsx, x1=tile[-1] + tsx, y0=tile_y[0] - tsy,
        y1=tile_y[-1] + tsy, fx0=tile[1] - tsx, fx1=tile[-2] + tsx, fy0=tile_y[1] - tsy, fy1=tile_y[-2] + tsy,
        threshold=_f32(env['threshold_pos']), max_episode_steps=float(env['max_episode_steps']),
        min_x=min_x, min_y=min_y, span_x=_f32(hi_x - margin) - min_x, span_y=_f32(hi_y - margin) - min_y,
        c_wall=c + offw, c_sample=c + off + offw, pair_sum=c + c, sample_pair_sum=(c + off) + (c + off),
        # the program's float32 tensor arithmetic: 2 * (c + offset)
        min_goal_dist=float(t(2.0) * (t(env['collision_size']) + t(off))),
    )
    return {k: _f32(x) for k, x in v.items()}


def _inside(f: dict, px, py, r):
    """Full-table rule for the circle of radius ``r``."""
    fast = (px >= f['fx0']) & (px <= f['fx1']) & (py >= f['fy0']) & (py <= f['fy1'])
    above = (px >= f['x0']) & (px <= f['x1']) & (py >= f['y0']) & (py <= f['y1'])
    inside = (px - r > f['x0']) & (px + r < f['x1']) & (py - r > f['y0']) & (py + r < f['y1'])
    return fast | (above & inside)


def _normal_pairs(noise: Stream, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``m`` consecutive normal pairs as two ``[m, B]`` tensors."""
    u = noise.planes[noise.i:noise.i + 2 * m]
    noise.i += 2 * m
    r = sqrt(-2.0 * torch.log(1.0 - u[0::2]))
    th = TWO_PI * u[1::2]
    return r * torch.cos(th), r * torch.sin(th)


def _two_pairs(noise: Stream, m: int):
    """Per mover two normal pairs (``n1, n2``, then ``n3, n4``), ``[m, B]`` each."""
    u = noise.planes[noise.i:noise.i + 4 * m].reshape(m, 4, -1)
    noise.i += 4 * m
    out = []
    for a in (0, 2):
        r = sqrt(-2.0 * torch.log(1.0 - u[:, a]))
        th = TWO_PI * u[:, a + 1]
        out += [r * torch.cos(th), r * torch.sin(th)]
    return out


def _pairs(m: int, device):
    """The pairs (i, j), i < j, in row order, made on ``device``."""
    ij = torch.triu_indices(m, m, 1, device=device)
    return ij[0], ij[1]


def _cycles(f: dict, num_cycles: int, m: int, noise: Stream, P, V, A, U):
    """The cycle loop over ``[M, B]`` planes of x and y: returns the new
    positions, velocities, accelerations and the wall and mover flags."""
    (px, py), (vx, vy), (ax, ay), (ux, uy) = P, V, A, U
    dt = f['dt']
    dt_t = torch.full((), dt, dtype=torch.float32, device=px.device)
    ii, jj = _pairs(m, px.device)
    zero = torch.zeros_like(px[0])
    done_f, wall_f, mover_f = zero, zero.clone(), zero.clone()
    for _ in range(num_cycles):
        done = done_f > 0.0
        nvx, nvy = _normal_pairs(noise, m)
        vmx, vmy = vx + nvx * f['std_vel'], vy + nvy * f['std_vel']
        bx, by = vmx + dt * ux, vmy + dt * uy
        norm = sqrt(bx * bx + by * by)
        vclamp = norm >= f['v_max']
        safe = torch.where(norm > 0, norm, 1.0)
        cnx, cny = f['v_max'] * bx / safe, f['v_max'] * by / safe
        nax = torch.where(vclamp, (cnx - vmx) / dt_t, ux)
        nay = torch.where(vclamp, (cny - vmy) / dt_t, uy)
        nvx_t = vx + dt * (1.0 * nax)
        nvy_t = vy + dt * (1.0 * nay)
        npx, npy = px + dt * nvx_t, py + dt * nvy_t
        wx, wy = _normal_pairs(noise, m)
        new_wall = (~_inside(f, npx + wx * f['std_pos'], npy + wy * f['std_pos'], f['c_wall'])).any(0)
        cx, cy = _normal_pairs(noise, m)
        mx, my = npx + cx * f['std_pos'], npy + cy * f['std_pos']
        dx, dy = mx[ii] - mx[jj], my[ii] - my[jj]
        new_mover = (sqrt(dx * dx + dy * dy) <= f['pair_sum']).any(0)
        px, py = torch.where(done, px, npx), torch.where(done, py, npy)
        vx, vy = torch.where(done, vx, nvx_t), torch.where(done, vy, nvy_t)
        ax, ay = torch.where(done, ax, nax), torch.where(done, ay, nay)
        wall_f = torch.where(done, wall_f, torch.where(new_wall, 1.0, 0.0))
        mover_f = torch.where(done, mover_f, torch.where(new_mover, 1.0, 0.0))
        done_f = torch.maximum(done_f, torch.maximum(wall_f, mover_f))
    return (px, py), (vx, vy), (ax, ay), wall_f, mover_f


def _sample_sets(f: dict, m: int, cand_k: int, noise: Stream, goal: bool):
    """The first accepted of ``cand_k`` sets of M positions (set 0 when none
    is): ``(x [M, B], y [M, B], found [B])``."""
    u = noise.planes[noise.i:noise.i + 2 * m * cand_k].reshape(cand_k, m, 2, -1)
    noise.i += 2 * m * cand_k
    cx = f['min_x'] + u[:, :, 0] * f['span_x']  # [K, M, B]
    cy = f['min_y'] + u[:, :, 1] * f['span_y']
    ok = _inside(f, cx, cy, f['c_sample']).all(1)  # [K, B]
    ii, jj = _pairs(m, cx.device)
    dx, dy = cx[:, ii] - cx[:, jj], cy[:, ii] - cy[:, jj]
    dist = sqrt(dx * dx + dy * dy)
    ok = ok & ((dist >= f['min_goal_dist']) if goal else ~(dist <= f['sample_pair_sum'])).all(1)
    found = ok.any(0)
    first = torch.where(found, torch.argmax(ok.to(torch.int32), dim=0), 0)
    idx = first[None, None].expand(1, m, -1)
    return cx.gather(0, idx)[0], cy.gather(0, idx)[0], found


def step(f: dict, num_cycles: int, m: int, cand_k: int, uniforms: torch.Tensor, st: torch.Tensor, U):
    """One autoreset step of ``8M + 1`` state planes (positions, velocities,
    control-space accelerations and goals, mover-major then x/y, and the
    step counter) under actions ``U = (ux, uy)`` ``[M, B]`` each.  Returns
    the new planes and ``(collided, unreached)``."""
    noise = Stream(uniforms)

    def xy(k):
        blk = st[2 * m * k:2 * m * (k + 1)]
        return blk[0::2], blk[1::2]

    P, V, A, G = xy(0), xy(1), xy(2), xy(3)
    steps = st[8 * m]
    (px, py), (vx, vy), (ax, ay), wall_f, mover_f = _cycles(f, num_cycles, m, noise, P, V, A, U)
    n1, n2, _, _ = _two_pairs(noise, m)
    agx, agy = px + n1 * f['std_pos'], py + n2 * f['std_pos']
    ddx, ddy = agx - G[0], agy - G[1]
    unreached = torch.where(sqrt(ddx * ddx + ddy * ddy) <= f['threshold'], 0.0, 1.0)
    num_unreached = torch.zeros_like(steps)
    for i in range(m):  # summed mover by mover
        num_unreached = num_unreached + unreached[i]
    collided = (wall_f > 0.0) | (mover_f > 0.0)
    new_steps = steps + 1.0
    done = collided | (num_unreached == 0.0) | (new_steps >= f['max_episode_steps'])
    sx, sy, s_found = _sample_sets(f, m, cand_k, noise, goal=False)
    gx, gy, g_found = _sample_sets(f, m, cand_k, noise, goal=True)
    _two_pairs(noise, m)  # the post-reset observation's draws
    noise.done()
    do_reset = done & s_found & g_found
    zero = torch.zeros_like(px)
    px, py = torch.where(do_reset, sx, px), torch.where(do_reset, sy, py)
    vx, vy = torch.where(do_reset, zero, vx), torch.where(do_reset, zero, vy)
    ax, ay = torch.where(do_reset, zero, ax), torch.where(do_reset, zero, ay)
    gx, gy = torch.where(do_reset, gx, G[0]), torch.where(do_reset, gy, G[1])
    steps = torch.where(do_reset, 0.0, new_steps)

    def inter(x, y):
        return torch.stack([x, y], 1).reshape(2 * m, -1)

    planes = torch.cat([inter(px, py), inter(vx, vy), inter(ax, ay), inter(gx, gy), steps[None]])
    return planes, collided, num_unreached


def signals(f: dict, steps_in, collided, unreached) -> tuple:
    """A step's reward (-50 on a collision, +50 when every goal is reached,
    else minus the goals unreached), termination and truncation."""
    all_in = unreached == 0.0
    reward = torch.where(collided, -REWARD_SUCCESS, torch.where(all_in, REWARD_SUCCESS, -unreached))
    return reward, collided | all_in, steps_in + 1.0 >= f['max_episode_steps']


def work(cfg: dict, batch: int = 4) -> dict:
    """One env step in parts, for ``opcount``: ``{name: (fn, inputs)}``.
    ``step``: a rollout's step with its signals (``step_features`` is the
    same: no feature blocks); ``cycles_<n>``: ``n`` control cycles;
    ``restart_<k>``: the start and goal searches over ``k`` sets each."""
    f, env = constants(cfg), cfg['env']
    m, num_cycles, cand_k = env['num_movers'], env['num_cycles'], cfg['cand_k']
    st = torch.zeros((8 * m + 1, batch))
    ux = uy = torch.zeros((m, batch))

    def fn(st, u, ux, uy):
        planes, collided, unreached = step(f, num_cycles, m, cand_k, u, st, (ux, uy))
        return [planes, *signals(f, st[8 * m], collided, unreached)]

    def cycles(n):
        def run(st, u, ux, uy):
            xy = [(st[2 * m * k:2 * m * (k + 1):2], st[2 * m * k + 1:2 * m * (k + 1):2]) for k in range(3)]
            return _cycles(f, n, m, Stream(u), *xy, (ux, uy))
        return run, (st, torch.rand((6 * m * n, batch)), ux, uy)

    def restart(k):
        def run(u):
            noise = Stream(u)
            return _sample_sets(f, m, k, noise, goal=False), _sample_sets(f, m, k, noise, goal=True)
        return run, (torch.rand((4 * m * k, batch)),)

    one = (fn, (st, torch.rand((noise_planes(num_cycles, m, cand_k), batch)), ux, uy))
    return {'step': one, 'step_features': one, 'cycles_1': cycles(1), 'cycles_2': cycles(2),
            'restart_1': restart(1), f'restart_{cand_k}': restart(cand_k)}


def state_planes(state) -> torch.Tensor:
    """The ``8M + 1`` f32 planes of an M-mover planning state's fields in
    acceleration mode (positions, velocities, accelerations, goals, step)."""
    b = state.pos.shape[0]
    blocks = [x.to(torch.float32).reshape(b, -1).T for x in (state.pos, state.vel, state.acc, state.goals)]
    return torch.cat(blocks + [state.steps.to(torch.float32)[None]])


def rollout(cfg: dict, planes: torch.Tensor, actions: torch.Tensor, seed: int, steps_per_launch: int = 1,
            dtype=torch.float32, features_out: bool = False):
    """``T`` steps from the ``8M + 1`` planes with actions ``[T, B, M, 2]``
    (clamped to the action limit here), step ``t`` keyed by ``seed + t``.
    Returns ``(planes, reward [T, B], terminated [T, B], truncated [T, B],
    None)``: the reward -50 on a collision, +50 when every goal is reached,
    else minus the goals unreached."""
    if steps_per_launch != 1:
        raise NotImplementedError('M-mover planning launches one step at a time')
    f, env = constants(cfg), cfg['env']
    m, num_cycles, cand_k = env['num_movers'], env['num_cycles'], cfg['cand_k']
    per = noise_planes(num_cycles, m, cand_k)
    b, device = planes.shape[1], planes.device
    lim = f['a_max']
    acts = torch.clamp(actions.to(torch.float32).reshape(-1, b, m, 2), -lim, lim).to(dtype)
    st = planes.to(dtype)
    one = Replay(lambda s, ux, uy, u: step(f, num_cycles, m, cand_k, u, s, (ux, uy)),
                 [st, acts[0, :, :, 0].T, acts[0, :, :, 1].T, torch.zeros((per, b), dtype=dtype, device=device)])
    rew, term, trunc = [], [], []
    for t in range(acts.shape[0]):
        steps_in = st[8 * m]
        u = launch_uniforms(seed + t, per, b, device).to(dtype)
        st, collided, unreached = (x.clone() for x in one(st, acts[t, :, :, 0].T, acts[t, :, :, 1].T, u))
        for out, x in zip((rew, term, trunc), signals(f, steps_in, collided, unreached)):
            out.append(x)
    return st, torch.stack(rew), torch.stack(term), torch.stack(trunc), None


def start_invalid(cfg: dict, state, stalled: torch.Tensor) -> int:
    """Envs of a freshly reset batch that break the configuration's start
    rules: every start and goal inside the sampling box, no two starts
    within the pair sum of each other and no two goals nearer than
    ``min_goal_dist`` (where the reset did not report a stall), every mover
    at rest, the step counter at 0."""
    f = constants(cfg)
    eps = 1e-6
    m = cfg['env']['num_movers']
    ii, jj = _pairs(m, state.pos.device)

    def within(xy):
        x, y = xy[..., 0], xy[..., 1]
        return ((x >= f['min_x'] - eps) & (x <= f['min_x'] + f['span_x'] + eps)
                & (y >= f['min_y'] - eps) & (y <= f['min_y'] + f['span_y'] + eps)).all(-1)

    def dist(xy):
        d = xy[:, ii].to(torch.float32) - xy[:, jj].to(torch.float32)
        return torch.sqrt((d * d).sum(-1))

    ok = within(state.pos) & within(state.goals)
    ok &= ((dist(state.pos) > f['sample_pair_sum'] - eps).all(-1)
           & (dist(state.goals) >= f['min_goal_dist'] - eps).all(-1)) | stalled
    for name in ('vel', 'acc', 'act'):
        ok &= (getattr(state, name) == 0).flatten(1).all(-1)
    ok &= state.steps == 0
    return int((~ok).sum())
