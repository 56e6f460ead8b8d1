"""M-mover planning kernel H: wrapper, plain PyTorch version, constants.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/pallas_step.py``
``_planning_multi_autoreset_kernel`` and the constants its wrapper
``make_fused_planning_multi_autoreset_cycles`` binds: one autoreset env step
of M movers (cycles with per-mover wall checks, all-pairs collision and the
shared-fate latch, observations, termination, joint start-set and goal-set
resampling).

State travels as f32 planes ``[8M + 1, B]``: positions, velocities,
control-space accelerations and goals (each ``2M`` planes, mover-major then
x/y), then the step counter; actions as ``[2M, B]``.  The kernel writes
``18M + 6`` planes (``n_multi_out``): the state, the post-reset observation
(velocity, achieved goal), the pre-reset observation (velocity, achieved
goal, activation), wall, mover, unreached goals, stalled, trials.  The plain
version does the kernel's arithmetic with the same operand order, one
rounding per operation, in the same draw order over a given uniform tensor.
Any M from 2 to ``MAX_MOVERS`` runs; on the card the wrapper lays each env
over a group of G lanes with L mover slots each (``lane_layout``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build, planning, to_numpy, walls
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import clamp_chain, scalar, sqrt
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import UniformStream

MAX_MOVERS = 64  # kMaxMovers in csrc/planning_multi.cuh (a block's shared memory)

#: (name, length rule) of the constants vector in ``csrc/planning_multi.cuh``
#: (``GPRT_MULTI_FIELDS``): ``m`` one value per mover, ``pairs`` one per pair
#: (i, j), i < j, in row order, ``1`` a scalar
MULTI_FIELDS = (
    ('c_wall_x', 'm'), ('c_wall_y', 'm'), ('c_sample_x', 'm'), ('c_sample_y', 'm'), ('c_sample_pair_x', 'm'),
    ('c_sample_pair_y', 'm'), ('c_pair_x', 'm'), ('c_pair_y', 'm'), ('accel_scale', 'm'), ('pair_sum', 'pairs'),
    ('sample_pair_sum_x', 'pairs'), ('sample_pair_sum_y', 'pairs'), ('min_goal_dist', '1'),
)

LANES = (1, 2, 4, 8, 16, 32)  # the G a lane group may have
SLOTS = (1, 2)  # the L the kernel is instantiated for: 32 lanes x 2 slots hold MAX_MOVERS

#: Kernel H's lane layout, (G lanes an env, L mover slots a lane), by the
#: movers' row (the smallest key >= M, ``table_row``) and the width: row ->
#: ((G, L) up to ``WIDE_BATCH`` envs, (G, L) above).  The fastest layouts of
#: ``chip_smoke.py``'s kernel H phase (``tools/rollout_rates.
#: kernel_h_layouts``) at 2, 4, 8 and 12 movers and 4096 and 65,536 envs: at
#: 4096 envs more lanes than movers win (the lanes without a mover draw), at
#: 65,536 few lanes up to 8 movers and all 32 at 12.  ``WIDE_BATCH``: at
#: 8192 envs the narrow layout was the faster of the two at 2, 4 and 8
#: movers, at 16,384 the wide one (at 4 movers 1.4% slower: a tie) (PERF.md
#: section 6).  Row 32 (13-32 movers) follows 12 movers, untimed; above 32
#: movers (32, 2) is the only layout.
WIDE_BATCH = 8192
LANE_TABLE = {
    2: ((8, 1), (1, 2)),
    4: ((8, 1), (2, 2)),
    8: ((16, 1), (4, 2)),
    32: ((32, 1), (32, 1)),
    64: ((32, 2), (32, 2)),
}


def table_row(m: int) -> int:
    """The key of ``LANE_TABLE`` whose row holds M movers: the smallest key
    >= M."""
    return min(k for k in LANE_TABLE if k >= m)


def check_movers(m: int) -> None:
    if not 2 <= m <= MAX_MOVERS:
        raise NotImplementedError(f'kernel H takes 2 to {MAX_MOVERS} movers (the shared memory of a block), got {m} '
                                  f'(ROADMAP.md)')


def layouts(m: int) -> tuple:
    """Every (G, L) kernel H can run M movers on: for each G in ``LANES``
    the fewest slots ``L`` in ``SLOTS`` with G * L >= M (where one exists);
    with G > M the lanes beyond M own no mover but draw."""
    check_movers(m)
    return tuple((g, min(n for n in SLOTS if g * n >= m)) for g in LANES if g * SLOTS[-1] >= m)


def lane_layout(m: int, b: int) -> tuple:
    """The (G, L) the wrapper launches for M movers at B envs
    (``LANE_TABLE``)."""
    check_movers(m)
    narrow, wide = LANE_TABLE[table_row(m)]
    return wide if b > WIDE_BATCH else narrow


def field_length(rule: str, m: int) -> int:
    return {'m': m, 'pairs': m * (m - 1) // 2, '1': 1}[rule]


def n_multi_state(m: int) -> int:
    return 8 * m + 1


def n_multi_out(m: int) -> int:
    """Output planes of kernel H: state 8M + 1, post-reset obs 4M, pre-reset
    obs 6M, wall, mover, unreached, stalled, trials."""
    return 18 * m + 6


def multi_noise_planes(num_cycles: int, m: int, cand_k: int, box: bool = False) -> int:
    """Uniforms one step draws (``_planning_multi_autoreset_noise_planes``):
    per cycle and mover a velocity pair, the wall-check pose and the
    pair-test pose (1 pair each for the circle, 3 for the box); the pre- and
    post-reset observations (2 pairs per mover each); the start and goal
    sampling (cand_k sets of M x/y uniforms each)."""
    p = 3 if box else 1
    return (2 + 4 * p) * m * num_cycles + 8 * m + 4 * m * cand_k


def pairs(m: int) -> list:
    """The mover pairs (i, j), i < j, in the kernels' order."""
    return [(i, j) for i in range(m) for j in range(i + 1, m)]


# ---------------------------------------------------------------------------
# constants (host side, float64 as the Pallas wrapper forms them)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiConsts:
    """Everything a kernel H launch needs besides its tensors: ``base`` the
    fields shared with kernels E-G (grid rule, dynamics, noise, sampling
    bounds), ``f`` each ``MULTI_FIELDS`` name's f32 values (Python floats,
    ``M``, ``M(M-1)/2`` or one), ``vector`` the same in field order, the
    constants vector kernel H reads from device memory."""

    base: planning.KernelConsts
    m: int
    f: dict
    vector: np.ndarray
    _vectors: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def vector_on(self, device: torch.device) -> torch.Tensor:
        """``vector`` on ``device``, made once (``make_multi_kernel_consts``
        makes it on the params' card, so no step copies it)."""
        if device not in self._vectors:
            self._vectors[device] = torch.from_numpy(self.vector).to(device)
        return self._vectors[device]


def make_multi_kernel_consts(config, params, cand_k: int = 16) -> MultiConsts:
    """The constants ``make_fused_planning_multi_autoreset_cycles`` binds
    into the Pallas kernel: per-mover sizes c_wall = c + offset_wall,
    c_sample = c + offset + offset_wall, c_sample_pair = c + offset, c_pair =
    c and the per-pair sums, formed in float64 and rounded once to f32."""
    m = config.num_movers
    check_movers(m)
    if config.collision_shape not in ('circle', 'box') or to_numpy(params.v_max).dtype != np.float32:
        raise NotImplementedError('the fused planning kernels run in f32; f64 params step through the eager step')
    box = config.collision_shape == 'box'
    offset = float(to_numpy(params.c_offset))
    offset_wall = float(to_numpy(params.c_offset_wall))
    if box:
        c_arr = to_numpy(params.c_size).astype(np.float64).reshape(m, 2)

        def inflate(extra):
            return [(float(cx) + extra, float(cy) + extra) for cx, cy in c_arr]

        c_wall, c_sample = inflate(offset_wall), inflate(offset + offset_wall)
        c_sample_pair, c_pair = inflate(offset), inflate(0.0)
    else:
        c_arr = to_numpy(params.c_size).astype(np.float64).reshape(m)
        c_wall = [(float(c) + offset_wall,) * 2 for c in c_arr]
        c_sample = [(float(c) + offset + offset_wall,) * 2 for c in c_arr]
        c_sample_pair = [(float(c) + offset,) * 2 for c in c_arr]
        c_pair = [(float(c),) * 2 for c in c_arr]
    v = {}
    for name, sizes in (('c_wall', c_wall), ('c_sample', c_sample), ('c_sample_pair', c_sample_pair),
                        ('c_pair', c_pair)):
        v[name + '_x'] = [s[0] for s in sizes]
        v[name + '_y'] = [s[1] for s in sizes]
    v['accel_scale'] = [float(a) for a in to_numpy(params.accel_scale).reshape(-1)]
    # the pair sums the Pallas kernel forms as Python floats
    v['pair_sum'] = [c_pair[i][0] + c_pair[j][0] for i, j in pairs(m)]
    v['sample_pair_sum_x'] = [c_sample_pair[i][0] + c_sample_pair[j][0] for i, j in pairs(m)]
    v['sample_pair_sum_y'] = [c_sample_pair[i][1] + c_sample_pair[j][1] for i, j in pairs(m)]
    v['min_goal_dist'] = [float(to_numpy(params.min_goal_dist))]
    rows = [np.asarray(v[name], np.float32) for name, _ in MULTI_FIELDS]
    assert [len(r) for r in rows] == [field_length(rule, m) for _, rule in MULTI_FIELDS]
    f = {name: [float(x) for x in row] for (name, _), row in zip(MULTI_FIELDS, rows)}
    mc = MultiConsts(base=planning.shared_consts(config, params, cand_k), m=m, f=f, vector=np.concatenate(rows))
    device = params.v_max.device
    if device.type == 'cuda':  # the step's constants and wall table on its card, made now
        mc.vector_on(device)
        mc.base.table_on(device)
    return mc


# ---------------------------------------------------------------------------
# plain version (same arithmetic, same draw order)
# ---------------------------------------------------------------------------


def _noisy_rotation(noise: UniformStream, std_pos: float):
    q1, q2 = noise.normal_pair()
    q3, q4 = noise.normal_pair()
    return walls.quat_to_R2(1.0 + q1 * std_pos, q2 * std_pos, q3 * std_pos, q4 * std_pos)


def rects_intersect_sat(tx, ty, Ra, ha, Rb, hb):
    """Rotated rectangles a and b (centre offset (tx, ty) = b - a): the
    four-axis SAT overlap (touching counts) minus strict containment."""
    ra00, ra01, ra10, ra11 = Ra
    rb00, rb01, rb10, rb11 = Rb
    (hax, hay), (hbx, hby) = ha, hb
    d00 = torch.abs(ra00 * rb00 + ra10 * rb10)
    d01 = torch.abs(ra00 * rb01 + ra10 * rb11)
    d10 = torch.abs(ra01 * rb00 + ra11 * rb10)
    d11 = torch.abs(ra01 * rb01 + ra11 * rb11)
    ta1 = torch.abs(tx * ra00 + ty * ra10)
    ta2 = torch.abs(tx * ra01 + ty * ra11)
    rb1 = hbx * d00 + hby * d01
    rb2 = hbx * d10 + hby * d11
    tb1 = torch.abs(tx * rb00 + ty * rb10)
    tb2 = torch.abs(tx * rb01 + ty * rb11)
    ra1 = hax * d00 + hay * d10
    ra2 = hax * d01 + hay * d11
    overlap = (ta1 <= hax + rb1) & (ta2 <= hay + rb2) & (tb1 <= hbx + ra1) & (tb2 <= hby + ra2)
    b_in_a = (ta1 + rb1 < hax) & (ta2 + rb2 < hay)
    a_in_b = (tb1 + ra1 < hbx) & (tb2 + ra2 < hby)
    return overlap & ~(b_in_a | a_in_b)


def rects_intersect_ident(tx, ty, ha, hb, sums):
    """``rects_intersect_sat`` at the identity orientation, with the summed
    half-extents ``sums`` formed in float64 (as the Pallas kernel's Python
    floats are)."""
    ax, ay = torch.abs(tx), torch.abs(ty)
    overlap = (ax <= sums[0]) & (ay <= sums[1])
    b_in_a = (ax + hb[0] < ha[0]) & (ay + hb[1] < ha[1])
    a_in_b = (ax + ha[0] < hb[0]) & (ay + ha[1] < hb[1])
    return overlap & ~(b_in_a | a_in_b)


def _cycles_plain(mc: MultiConsts, noise: UniformStream, P, V, A, U):
    """The cycle loop: returns the new P, V, A plane lists, the wall and
    mover flags and the cycles each env ran up to its latch (the kernel
    leaves the loop there)."""
    kc, mf, m = mc.base, mc.f, mc.m
    f = kc.f
    dt, std_pos, std_vel = f['dt'], f['std_pos'], f['std_vel']
    dt_t = scalar(dt, P[0])
    done_f = torch.zeros_like(P[0])
    wall_f = torch.zeros_like(P[0])
    mover_f = torch.zeros_like(P[0])
    ran = torch.zeros_like(P[0])
    for _ in range(kc.num_cycles):
        done = done_f > 0.0
        ran = ran + torch.where(done, 0.0, 1.0)
        nP, nV, nA = [None] * (2 * m), [None] * (2 * m), [None] * (2 * m)
        for i in range(m):
            x, y, s = 2 * i, 2 * i + 1, mf['accel_scale'][i]
            nvx, nvy = noise.normal_pair()
            vmx = V[x] + nvx * std_vel
            vmy = V[y] + nvy * std_vel
            nA[x], nA[y] = clamp_chain(kc.learn_jerk, f['v_max'], f['a_max'], dt, dt_t, vmx, vmy, U[x], U[y],
                                       s * A[x], s * A[y], A[x], A[y])
            nV[x] = V[x] + dt * (s * nA[x])
            nV[y] = V[y] + dt * (s * nA[y])
            nP[x] = P[x] + dt * nV[x]
            nP[y] = P[y] + dt * nV[y]
        new_wall = torch.zeros_like(done)
        for i in range(m):
            size = (mf['c_wall_x'][i], mf['c_wall_y'][i])
            new_wall = new_wall | ~walls.wall_check(kc.rule, kc.box, noise, nP[2 * i], nP[2 * i + 1], std_pos, size)
        mx, my, mr = [], [], []
        for i in range(m):
            cx, cy = noise.normal_pair()
            mx.append(nP[2 * i] + cx * std_pos)
            my.append(nP[2 * i + 1] + cy * std_pos)
            if kc.box:
                mr.append(_noisy_rotation(noise, std_pos))
        new_mover = torch.zeros_like(done)
        for p, (i, j) in enumerate(pairs(m)):
            if kc.box:
                hit = rects_intersect_sat(mx[j] - mx[i], my[j] - my[i], mr[i], (mf['c_pair_x'][i], mf['c_pair_y'][i]),
                                          mr[j], (mf['c_pair_x'][j], mf['c_pair_y'][j]))
            else:
                dx, dy = mx[i] - mx[j], my[i] - my[j]
                hit = sqrt(dx * dx + dy * dy) <= mf['pair_sum'][p]
            new_mover = new_mover | hit
        P = [torch.where(done, a, b) for a, b in zip(P, nP)]
        V = [torch.where(done, a, b) for a, b in zip(V, nV)]
        A = [torch.where(done, a, b) for a, b in zip(A, nA)]
        wall_f = torch.where(done, wall_f, torch.where(new_wall, 1.0, 0.0))
        mover_f = torch.where(done, mover_f, torch.where(new_mover, 1.0, 0.0))
        done_f = torch.maximum(done_f, torch.maximum(wall_f, mover_f))
    return P, V, A, wall_f, mover_f, ran


def _sample_set_plain(mc: MultiConsts, noise: UniformStream, goal: bool):
    """First accepted of cand_k candidate sets of M positions: (set, found,
    trials)."""
    kc, mf, m = mc.base, mc.f, mc.m
    f = kc.f
    best, found, trials = None, None, None
    for _ in range(kc.cand_k):
        cand = []
        for _i in range(m):
            cand += [noise.uniform_in(f['min_x'], f['span_x']), noise.uniform_in(f['min_y'], f['span_y'])]
        if found is None:
            found = torch.zeros_like(cand[0])
            trials = torch.zeros_like(cand[0])
        trials = trials + (1.0 - found)
        ok = torch.ones_like(cand[0], dtype=torch.bool)
        for i in range(m):
            ok = ok & walls.sample_valid_at(kc.rule, kc.box, cand[2 * i], cand[2 * i + 1],
                                            (mf['c_sample_x'][i], mf['c_sample_y'][i]))
        for p, (i, j) in enumerate(pairs(m)):
            dx, dy = cand[2 * i] - cand[2 * j], cand[2 * i + 1] - cand[2 * j + 1]
            if goal:
                ok = ok & (sqrt(dx * dx + dy * dy) >= mf['min_goal_dist'][0])
            elif kc.box:
                ok = ok & ~rects_intersect_ident(
                    cand[2 * j] - cand[2 * i], cand[2 * j + 1] - cand[2 * i + 1],
                    (mf['c_sample_pair_x'][i], mf['c_sample_pair_y'][i]),
                    (mf['c_sample_pair_x'][j], mf['c_sample_pair_y'][j]),
                    (mf['sample_pair_sum_x'][p], mf['sample_pair_sum_y'][p]))
            else:
                ok = ok & ~(sqrt(dx * dx + dy * dy) <= mf['sample_pair_sum_x'][p])
        take = ok & (found == 0.0)
        best = list(cand) if best is None else [torch.where(take, c, b) for c, b in zip(cand, best)]
        found = torch.maximum(found, torch.where(ok, 1.0, 0.0))
    return best, found, trials


def _autoreset_step_plain(mc: MultiConsts, noise: UniformStream, st, U):
    """One step: ``8M + 1`` state planes in, the ``18M + 6`` output planes
    (as a list) out."""
    kc, m = mc.base, mc.m
    f = kc.f
    std_pos, std_vel = f['std_pos'], f['std_vel']
    P, V, A, G = (list(st[k * 2 * m:(k + 1) * 2 * m]) for k in range(4))
    steps = st[8 * m]
    P, V, A, wall_f, mover_f, _ = _cycles_plain(mc, noise, P, V, A, U)
    f_A = list(A)

    f_ag, f_v = [], []
    num_unreached = torch.zeros_like(steps)
    for i in range(m):
        n1, n2 = noise.normal_pair()
        n3, n4 = noise.normal_pair()
        f_ag += [P[2 * i] + n1 * std_pos, P[2 * i + 1] + n2 * std_pos]
        f_v += [V[2 * i] + n3 * std_vel, V[2 * i + 1] + n4 * std_vel]
        ddx, ddy = f_ag[2 * i] - G[2 * i], f_ag[2 * i + 1] - G[2 * i + 1]
        num_unreached = num_unreached + torch.where(sqrt(ddx * ddx + ddy * ddy) <= f['threshold'], 0.0, 1.0)
    collided = (wall_f > 0.0) | (mover_f > 0.0)
    term = collided | (num_unreached == 0.0)
    new_steps = steps + 1.0
    done = term | (new_steps >= f['max_episode_steps'])

    starts, s_found, s_trials = _sample_set_plain(mc, noise, goal=False)
    goals, g_found, g_trials = _sample_set_plain(mc, noise, goal=True)
    # a stalled sampler does not restart the env: state and counter carry over
    found = (s_found > 0.0) & (g_found > 0.0)
    stalled_f = torch.where(done & ~found, 1.0, 0.0)
    do_reset = done & found
    P = [torch.where(do_reset, s, p) for s, p in zip(starts, P)]
    V = [torch.where(do_reset, 0.0, v) for v in V]
    A = [torch.where(do_reset, 0.0, a) for a in A]
    G = [torch.where(do_reset, g, x) for g, x in zip(goals, G)]
    steps = torch.where(do_reset, 0.0, new_steps)

    s_ag, s_v = [], []
    for i in range(m):
        n1, n2 = noise.normal_pair()
        n3, n4 = noise.normal_pair()
        s_ag += [torch.where(do_reset, P[2 * i] + n1 * std_pos, f_ag[2 * i]),
                 torch.where(do_reset, P[2 * i + 1] + n2 * std_pos, f_ag[2 * i + 1])]
        s_v += [torch.where(do_reset, V[2 * i] + n3 * std_vel, f_v[2 * i]),
                torch.where(do_reset, V[2 * i + 1] + n4 * std_vel, f_v[2 * i + 1])]
    return (P + V + A + G + [steps] + s_v + s_ag + f_v + f_ag + f_A
            + [wall_f, mover_f, num_unreached, stalled_f, torch.where(done, s_trials + g_trials, 0.0)])


def planning_multi_autoreset_plain(state: torch.Tensor, action: torch.Tensor, mc: MultiConsts,
                                   uniforms: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel H: ``[8M + 1, B]`` state + ``[2M, B]`` action
    -> ``[18M + 6, B]`` over ``[multi_noise_planes, B]`` uniforms."""
    noise = UniformStream(uniforms)
    out = _autoreset_step_plain(mc, noise, list(state), list(action))
    noise.finalize()
    return torch.stack(out)


def cycles_run_plain(state: torch.Tensor, action: torch.Tensor, mc: MultiConsts,
                     uniforms: torch.Tensor) -> torch.Tensor:
    """``[B]``: the control cycles each env of a kernel H step runs, up to
    and including the one that latches it (the work its data needs)."""
    m = mc.m
    P, V, A = (list(state[k * 2 * m:(k + 1) * 2 * m]) for k in range(3))
    return _cycles_plain(mc, UniformStream(uniforms), P, V, A, list(action))[5]


# ---------------------------------------------------------------------------
# CUDA launch and dispatch
# ---------------------------------------------------------------------------


def _noise_planes(mc: MultiConsts) -> int:
    return multi_noise_planes(mc.base.num_cycles, mc.m, mc.base.cand_k, mc.base.box)


def planning_multi_autoreset_cuda(state, action, mc: MultiConsts, uniforms=None,
                                  seed: int | torch.Tensor = 0) -> torch.Tensor:
    """Kernel H on the card, in the lane layout ``lane_layout(M, B)``."""
    b, m = state.shape[1], mc.m
    kernels.check_plane(state, 'state', (n_multi_state(m), b))
    kernels.check_plane(action, 'action', (2 * m, b))
    noise_ptr = kernels.noise_ptr(uniforms, _noise_planes(mc), b, state.device)
    fields = build.lib().multi_const_fields
    if fields != MULTI_FIELDS:
        raise RuntimeError(f'the constants fields of planning_multi.cuh differ from MULTI_FIELDS: {fields}')
    lanes, slots = lane_layout(m, b)
    kc = mc.base
    args = planning.launch_args(kc, state.device)
    out = torch.empty((n_multi_out(m), b), dtype=torch.float32, device=state.device)
    with torch.cuda.device(state.device):
        err = build.lib().gprt_planning_multi_autoreset(
            state.data_ptr(), action.data_ptr(), noise_ptr, out.data_ptr(), b, args[0],
            mc.vector_on(state.device).data_ptr(), args[1], args[2], m, lanes, slots, *args[3:], kc.cand_k,
            *kernels.seed_args(seed, state.device), kernels.stream_ptr(out),
        )
    build.check(err, 'planning_multi_autoreset')
    kernels.LAUNCHES['planning_multi_autoreset'] += 1
    return out


def planning_multi_autoreset(state, action, mc: MultiConsts, *, uniforms=None, seed: int | None = None,
                             generator=None):
    """Kernel H, or its plain version on CPU tensors (``kernels.dispatch``)."""
    return kernels.dispatch((state, action), _noise_planes(mc), uniforms, seed, generator,
                            lambda u: planning_multi_autoreset_plain(state, action, mc, u),
                            lambda u, s: planning_multi_autoreset_cuda(state, action, mc, u, s))
