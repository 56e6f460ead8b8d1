"""Fused rollout rates on the card, in env-steps/s, and kernel H's launch time.

Pushing (``--family pushing``): times ``pushing.make_fused_rollout`` over 64
steps at K = 1 (kernel C once a step) and K = 32 (kernel D), at 4096 and
65,536 envs, as ``chip_smoke.py``'s ``rollout_rate`` phase does.  With
``--profile`` each cell also runs one rollout under ``torch.profiler`` and
reports the card's busy time in it and each kernel's device ms per launch.
Each width also reports kernel C alone (``launch_cost``): the host's time to
enqueue a launch and the card's time per launch back to back.

M-mover planning (``--family multi``): ``planning.make_fused_rollout`` of
the M-mover main configuration (4x4 table, 4 movers, circle; bench.py:401)
over 64 steps at K = 1 (kernel H once a step), at 4096 and 65,536 envs; and
kernel H's device ms per launch at 2, 4, 8 and 12 movers (3x3, 4x4, 6x6
and 8x8 tables) at both widths, on a state eight random steps
into a rollout, in the layout the tree's wrapper picks (a tree that does
not take M movers reports the error), and at 4 movers also without the
control cycles.  ``--family layouts``: the same launches in every lane
layout (G, L) kernel H takes, the table the wrapper's ``LANE_TABLE`` is
read from (``--movers`` and ``--widths`` narrow it, e.g. to the widths
around ``WIDE_BATCH``).  ``--family many``: kernel H's device ms per launch
(the profiler's, median of 5) at 40 cycles and ``cand_k`` 16
on ``ladder_state``'s planted, cycles-only and sets-only states of
``--movers`` (default 129 and 256) on a ladder of slots, circle and box, at
``--widths`` (default 4096), in the wrapper's layout or, with
``--every-layout``, in each slot layout with the many-mover variant forced
beside them (random start sets stall from about 33 movers, so these states
are planted).

Single-mover planning (``--family planning``): ``planning.make_fused_rollout``
of the default configuration (3x3 table, circle r=0.11, acc, 40 cycles;
bench.py:213) over 64 steps at K = 1 (kernel F once a step) and K = 32
(kernel G), at 4096 and 65,536 envs, with the host's share of each
rollout; and kernels F and G's device ms per launch (G at K = 32; the
profiler's kernel records) at each of ``--widths`` (default 4096-65,536)
for the circle and the box on the full and a holed table (``--configs``),
on a state
eight random steps into a rollout, in both block shapes where the tree's
wrapper has ``planning.uses_producer`` (thread-per-env, and the consumer
with its producer warps), else in the wrapper's: the table ``WIDE_BATCH``
is read from.  The producer-warp count is compiled in
(``kPlanningProducers``, ``csrc/planning.cuh``): to time another, change it
there and run again.

The cycles kernels (``--family cycles``): kernel A's device ms per launch at
the main path's shape (3 normal pairs at 4096 envs, the injected uniforms
its path draws, and its Philox mode); kernel B's (circle and box, acc) and
kernel E's (the four ``PLAN_CONFIGS``) at each of ``--widths`` (default
4096-65,536) on a state eight random steps into a rollout, in both block
shapes where the tree's wrapper switches B and E
(``uses_producer(b, kc, 'cycles')``), else in the wrapper's: the tables
``pushing.WIDE_BATCH`` and ``planning.WIDE_BATCH`` read B's and E's entries
from.  Beside them, the ms a step of each family's public
``make_fused_step`` (kernel B, kernel E) at 4096 envs, with the host's time
to enqueue a step.

Every cell runs ``--repeats`` times and reports every repeat, their median
and their spread ((max - min) / median), and the host's time to enqueue each
rollout, with the card's name and power limit in the JSON line printed.

It imports the package from wherever Python finds it, so two trees can be
compared on one card by running this file with each tree on ``PYTHONPATH``
in turn, alternating (a, b, b, a)::

    PYTHONPATH=path/to/tree python gymnasium_planar_robotics_tpu_torch/tools/rollout_rates.py --label tree
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch

T_ROLL = 64
WIDTHS = (4096, 65536)
KS = (1, 32)


def time_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()`` over ``iters`` calls after
    one warm-up: CUDA events around the calls, and the host's time to
    enqueue them (the two are equal when the host sets the rate)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def device_profile(fn) -> dict:
    """The card's work in one call of ``fn()``: its busy ms (kernel time
    summed) and, for each kernel name, launches and ms per launch."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(evt.name, (0, 0.0))
            kernels[evt.name] = (n + 1, us + evt.time_range.elapsed_us())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:4]
    return {'busy_ms': sum(us for _, us in kernels.values()) / 1e3,
            'kernels': {name[:60]: {'launches': n, 'ms_per_launch': us / n / 1e3} for name, (n, us) in top}}


#: takes of ``launch_device_runs`` in which the profiler handed back fewer
#: kernel records than launches ('retaken'), and calls that then fell back
#: to CUDA events ('timed_by_events'); ``chip_smoke.py`` reports them
PROFILER_MISSES = {'retaken': 0, 'timed_by_events': 0}


def launch_device_runs(fn, launches: int, takes: int = 3) -> list:
    """The card's ms of each of ``launches`` calls of ``fn()`` (one kernel a
    call) back to back, from the profiler's kernel records: the device's
    time whatever the host's rate of enqueueing them.  The profiler now and
    then hands back no kernel records at all; such a take is profiled again,
    and after ``takes`` takes short of records each call is timed between
    two CUDA events instead (the kernel and the gap before it), counted in
    ``PROFILER_MISSES``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(takes):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        runs = [evt.time_range.elapsed_us() / 1e3 for evt in prof.events()
                if evt.device_type == torch.autograd.DeviceType.CUDA]
        if len(runs) >= launches:
            return runs
        PROFILER_MISSES['retaken'] += 1
    PROFILER_MISSES['timed_by_events'] += 1
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(launches)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def launch_device_ms(fn, launches: int) -> float:
    """The median of ``launch_device_runs``."""
    return statistics.median(launch_device_runs(fn, launches))


def launch_cost(b: int, device: str = 'cuda:0', groups: int = 20, per_group: int = 16) -> dict:
    """Kernel C alone at ``b`` envs through its public wrapper: the host's
    microseconds to enqueue one launch (the queue drained after every
    ``per_group`` launches, so it never fills) and the card's ms per launch
    back to back (CUDA events over ``groups * per_group`` launches)."""
    from gymnasium_planar_robotics_tpu_torch.models import pushing
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

    cfg, prm = pushing.make_pushing_env(device=device)
    kc = kpush.make_kernel_consts(cfg, prm, 32)
    state, _, _ = pushing.init_batch(cfg, prm, b, torch.Generator(device=device).manual_seed(2))
    st = pushing.state_to_planes(state)
    act = torch.zeros((2, b), device=device)
    host = []
    for _ in range(groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_group):
            kpush.pushing_autoreset_cuda(st, act, kc, None, 7)
        host.append((time.perf_counter() - t0) * 1e6 / per_group)
    device_ms, _ = time_ms(lambda: kpush.pushing_autoreset_cuda(st, act, kc, None, 7), groups * per_group)
    return {'host_us_per_launch': statistics.median(host), 'host_us_range': [min(host), max(host)],
            'device_ms_per_launch': device_ms}


def wide_table(module, wide: int):
    """``module.WIDE_BATCH`` with every entry ``wide``: an int, or a table by
    configuration of tuples (a parent tree's) or of ``{kernel: envs}``."""
    table = module.WIDE_BATCH
    if isinstance(table, int):
        return wide
    return {k: dict.fromkeys(v, wide) if isinstance(v, dict) else (wide,) * len(v) for k, v in table.items()}


class forced_shape:
    """Within the block, every kernel of ``module`` (``ops.kernels.pushing``
    or ``planning``) launches blocks with the producer (``producer`` 1) or
    without (0) at every width (``WIDE_BATCH`` patched)."""

    def __init__(self, module, producer: int):
        self.module, self.wide = module, (1 << 62) if producer else 0

    def __enter__(self):
        self.saved = self.module.WIDE_BATCH
        self.module.WIDE_BATCH = wide_table(self.module, self.wide)

    def __exit__(self, *exc):
        self.module.WIDE_BATCH = self.saved


def switches_cycles(module) -> bool:
    """Whether the tree's wrapper launches its cycles kernel (B or E) in both
    block shapes: a ``cycles`` entry in each row of ``WIDE_BATCH``."""
    table = getattr(module, 'WIDE_BATCH', None)
    return isinstance(table, dict) and all(isinstance(v, dict) and 'cycles' in v for v in table.values())


def rates(repeats: int, profile: bool = False, device: str = 'cuda:0') -> dict:
    from gymnasium_planar_robotics_tpu_torch.models import pushing

    out = {}
    for b in WIDTHS:
        cfg, prm = pushing.make_pushing_env(device=device)
        g = torch.Generator(device=device).manual_seed(2)
        state, _, _ = pushing.init_batch(cfg, prm, b, g)
        acts = (torch.rand((T_ROLL, b, 2), generator=g, device=device) * 2 - 1) * 10.0
        for k in KS:
            roll = pushing.make_fused_rollout(cfg, prm, steps_per_launch=k)
            timings = [time_ms(lambda: roll(state, acts, 3), 3) for _ in range(repeats)]
            runs = [b * T_ROLL / (ms / 1e3) for ms, _ in timings]
            med = statistics.median(runs)
            cell = {'env_steps_per_s': runs, 'median': med, 'spread': (max(runs) - min(runs)) / med,
                    'host_ms_per_rollout': [host for _, host in timings]}
            if profile:
                cell['profile'] = device_profile(lambda: roll(state, acts, 3))
            out[f'B={b},K={k}'] = cell
        out[f'B={b},kernel_C'] = launch_cost(b, device)
    return out


MULTI_M = 4  # the M-mover main configuration (bench.py:401): 4x4 table, circle r=0.11, cand_k=16
MULTI_TABLES = {2: 3, 4: 4, 8: 6, 12: 8}  # movers -> side of the full square table kernel H is timed on


def multi_rollout_state(m: int, b: int, seed: int, device: str = 'cuda:0', steps: int = 8):
    """(config, params, state) of M movers on their ``MULTI_TABLES`` table:
    ``init_batch``, then ``steps`` fused autoreset steps of uniform random
    actions in [-10, 10], so the envs are mid-episode as kernel H finds them
    on the rollout path (some moving fast, some about to collide)."""
    import numpy as np

    from gymnasium_planar_robotics_tpu_torch.models import planning

    side = MULTI_TABLES[m]
    cfg, prm = planning.make_planning_env(np.ones((side, side)), m, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = planning.init_batch(cfg, prm, b, g)
    step = planning.make_fused_step_autoreset(cfg, prm)
    for _ in range(steps):
        state = step(state, (torch.rand((b, m, 2), generator=g, device=device) * 2 - 1) * 10.0, generator=g)[0]
    return cfg, prm, state


def kernel_h_ms(m: int, b: int, device: str = 'cuda:0', launches: int = 100, num_cycles: int | None = None) -> dict:
    """Kernel H's device ms per launch (Philox, seed 7) at M movers and B
    envs on ``multi_rollout_state``, back to back, in the wrapper's layout;
    ``num_cycles`` overrides the env's control cycles (0: the observations
    and the restart alone)."""
    import dataclasses

    from gymnasium_planar_robotics_tpu_torch.models import planning
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti

    try:
        cfg, prm, state = multi_rollout_state(m, b, 3, device)
        mc = kmulti.make_multi_kernel_consts(cfg, prm)
    except NotImplementedError as exc:
        return {'error': str(exc)}
    if num_cycles is not None:
        mc = dataclasses.replace(mc, base=dataclasses.replace(mc.base, num_cycles=num_cycles))
    st = planning.state_to_planes(cfg, state)
    act = ((torch.rand((2 * m, b), generator=torch.Generator(device=device).manual_seed(4), device=device) * 2 - 1)
           * 10.0)
    ms, _ = time_ms(lambda: kmulti.planning_multi_autoreset_cuda(st, act, mc, None, 7), launches)
    layout = getattr(kmulti, 'lane_layout', None)
    return {'device_ms_per_launch': ms, 'lanes': None if layout is None else list(layout(m, b))}


class forced_layout:
    """Within the block, kernel H launches M movers in ``layout`` (G, L)
    whatever the width (``planning_multi.LANE_TABLE`` patched)."""

    def __init__(self, m: int, layout: tuple):
        from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti

        self.table, self.row, self.layout = kmulti.LANE_TABLE, kmulti.table_row(m), tuple(layout)

    def __enter__(self):
        self.saved = self.table[self.row]
        self.table[self.row] = (self.layout, self.layout)

    def __exit__(self, *exc):
        self.table[self.row] = self.saved


def kernel_h_layouts(movers=tuple(MULTI_TABLES), widths=WIDTHS, device: str = 'cuda:0', launches: int = 100) -> dict:
    """Kernel H's device ms per launch at each M and width in every lane
    layout (G, L) it takes for M (``planning_multi.layouts``), on
    ``multi_rollout_state``: the table ``LANE_TABLE`` is read from."""
    from gymnasium_planar_robotics_tpu_torch.models import planning
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti

    out = {}
    for m in movers:
        for b in widths:
            cfg, prm, state = multi_rollout_state(m, b, 30 + m, device)
            mc = kmulti.make_multi_kernel_consts(cfg, prm)
            st = planning.state_to_planes(cfg, state)
            act = ((torch.rand((2 * m, b), generator=torch.Generator(device=device).manual_seed(4), device=device)
                    * 2 - 1) * 10.0)
            times = {}
            for layout in kmulti.layouts(m):
                with forced_layout(m, layout):
                    times['G={},L={}'.format(*layout)] = time_ms(
                        lambda: kmulti.planning_multi_autoreset_cuda(st, act, mc, None, 7), launches)[0]
            picked = 'G={},L={}'.format(*kmulti.lane_layout(m, b))
            out[f'M={m},B={b}'] = {'ms': times, 'fastest': min(times, key=times.get), 'wrapper': picked,
                                   'wrapper_over_fastest': times[picked] / min(times.values())}
    return out


#: the box kernel H's many-mover timings use (half-extents; chip_smoke.py's box planning configurations)
LADDER_BOX = {'shape': 'box', 'size': [0.09, 0.08]}
#: the states of ``ladder_state``: 'planted' (a quarter of the envs at a wall, a quarter head-on, every 8th
#: about to truncate), 'cycles' (no env done: every env runs all its cycles, none samples), 'sets' (every
#: env latched by a wall in cycle 0: one cycle, then the restart's 2 x cand_k candidate sets)
LADDER_STATES = ('planted', 'cycles', 'sets')


def ladder_state(m: int, box: bool, b: int, num_cycles: int, kind: str = 'planted', device: str = 'cuda:0'):
    """(config, params, state planes, action planes) of M movers on a square
    grid of slots 0.42 m apart on the smallest full table that holds them
    with 0.3 m margins (circle r = 0.11, or ``LADDER_BOX``), at
    ``num_cycles`` cycles, in one of ``LADDER_STATES``.  'planted': envs
    [0, b/4) with mover 0 at the -x wall moving out at 1 m/s, envs
    [b/4, b/2) with movers 0 and 1 1 mm apart head-on; random velocities,
    accelerations and actions, every 8th env about to truncate.  'cycles':
    the movers at rest on their slots, actions in [-0.5, 0.5] (a mover moves
    under 4 cm in 40 cycles), no env about to truncate.  'sets': the planted
    state with mover 0 1 cm into the -x wall in every env.  Goals are random
    in every state (random sets of this many movers are never apart, so
    ``init_batch`` has no part here)."""
    import math

    import numpy as np

    from gymnasium_planar_robotics_tpu_torch.models import planning

    nx = math.ceil(math.sqrt(m))
    side = math.ceil((0.6 + 0.42 * (nx - 1)) / 0.24)
    cfg, prm = planning.make_planning_env(np.ones((side, side)), m, collision_params=LADDER_BOX if box else {},
                                          num_cycles=num_cycles, std_noise=[2e-3, 5e-2, 1e-5], device=device)
    g = torch.Generator(device=device).manual_seed(40 + m)
    slots = torch.tensor([(0.3 + 0.42 * i, 0.3 + 0.42 * j) for i in range(nx) for j in range(nx)][:m],
                         device=device)
    pos = slots[None] + (torch.rand((b, m, 2), generator=g, device=device) - 0.5) * 0.01
    vel = (torch.rand((b, m, 2), generator=g, device=device) - 0.5) * 0.6
    hx = prm.c_size.reshape(m, -1)[:, 0]
    q = b // 4
    pos[:q, 0, 0] = torch.linspace(float(hx[0]) - 0.01, float(hx[0]) + 0.02, q, device=device)
    vel[:q, 0] = torch.tensor([-1.0, 0.1], device=device)
    pos[q:2 * q, 1] = pos[q:2 * q, 0] + torch.stack([hx[0] + hx[1] + 1e-3, torch.zeros_like(hx[0])])
    vel[q:2 * q, 0] = torch.tensor([1.0, 0.0], device=device)
    vel[q:2 * q, 1] = torch.tensor([-1.0, 0.0], device=device)
    acc = (torch.rand((b, m, 2), generator=g, device=device) - 0.5) * 10.0
    goals = prm.min_xy + torch.rand((b, m, 2), generator=g, device=device) * (prm.max_xy - prm.min_xy)
    steps = torch.randint(0, cfg.max_episode_steps - 5, (b,), generator=g, device=device, dtype=torch.int32)
    act = ((torch.rand((2 * m, b), generator=g, device=device) * 2 - 1) * 8.0).contiguous()
    if kind == 'cycles':
        pos = slots[None] + (pos - slots[None]).clamp(-0.005, 0.005)
        vel.zero_()
        acc.zero_()
        act = act / 16.0
    else:
        steps[::8] = cfg.max_episode_steps - 1
        if kind == 'sets':
            pos[:, 0] = slots[0]
            pos[:, 0, 0] = float(hx[0]) - 0.01
            vel[:, 0] = torch.tensor([-1.0, 0.1], device=device)
    state = planning.PlanningState(pos=pos, vel=vel, acc=acc, act=acc.clone(), goals=goals, steps=steps)
    return cfg, prm, planning.state_to_planes(cfg, state), act


def kernel_h_many_ms(movers, widths=(4096,), every_layout=False, launches: int = 5, device: str = 'cuda:0') -> dict:
    """Kernel H's device ms per launch (Philox, seed 7; the profiler's
    kernel records, median of ``launches``) at 40 cycles and ``cand_k`` 16
    on each of ``LADDER_STATES`` at each M, circle and box, and width: in
    the wrapper's layout, or with
    ``every_layout`` in each layout ``planning_multi.layouts(M)`` lists and
    the many-mover variant (32, ``SMEM_SLOTS``) forced, each launch's
    planes checked equal to the first layout's; with each median its
    launches' spread ((max - min) / median).  Beside the times, what the
    state made the launch do: the envs done, the candidate sets tested, the
    wall and mover latches."""
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti

    out = {}
    for m in movers:
        for shape in ('circle', 'box'):
            for b in widths:
                for kind in LADDER_STATES:
                    cfg, prm, st, act = ladder_state(m, shape == 'box', b, 40, kind, device)
                    mc = kmulti.make_multi_kernel_consts(cfg, prm, 16)
                    lays = [tuple(kmulti.lane_layout(m, b))]
                    if every_layout:
                        lays = sorted({*kmulti.layouts(m), (32, kmulti.SMEM_SLOTS)}, key=lambda lay: -lay[1])
                    ms, spreads, first, equal = {}, {}, None, True
                    for lay in lays:
                        with forced_layout(m, lay):
                            def fn():
                                return kmulti.planning_multi_autoreset_cuda(st, act, mc, None, 7)

                            got = fn()
                            runs = launch_device_runs(fn, launches)
                        key = 'G={},L={}'.format(*lay)
                        ms[key] = statistics.median(runs)
                        spreads[key] = (max(runs) - min(runs)) / ms[key]
                        first = got if first is None else first
                        equal = equal and torch.equal(got, first)
                    trials = first[18 * m + 5]
                    out[f'M={m},{shape},B={b},{kind}'] = {
                        'device_ms': ms, 'spread': spreads, 'wrapper': 'G={},L={}'.format(*kmulti.lane_layout(m, b)),
                        'layouts_equal': equal, 'done': int((trials > 0).sum()), 'sets_tested': float(trials.sum()),
                        'wall_hits': int((first[18 * m + 1] > 0).sum()),
                        'mover_hits': int((first[18 * m + 2] > 0).sum())}
    return out


def multi_rates(repeats: int, profile: bool = False, device: str = 'cuda:0') -> dict:
    from gymnasium_planar_robotics_tpu_torch.models import planning

    out = {}
    for b in WIDTHS:
        cfg, prm, state = multi_rollout_state(MULTI_M, b, 2, device, steps=0)
        g = torch.Generator(device=device).manual_seed(5)
        acts = (torch.rand((T_ROLL, b, MULTI_M, 2), generator=g, device=device) * 2 - 1) * 10.0
        roll = planning.make_fused_rollout(cfg, prm)
        timings = [time_ms(lambda: roll(state, acts, 3), 3) for _ in range(repeats)]
        runs = [b * T_ROLL / (ms / 1e3) for ms, _ in timings]
        med = statistics.median(runs)
        cell = {'env_steps_per_s': runs, 'median': med, 'spread': (max(runs) - min(runs)) / med,
                'host_ms_per_rollout': [host for _, host in timings]}
        if profile:
            cell['profile'] = device_profile(lambda: roll(state, acts, 3))
        out[f'B={b},M={MULTI_M},K=1'] = cell
        for m in MULTI_TABLES:
            out[f'B={b},kernel_H,M={m}'] = kernel_h_ms(m, b, device)
        # the main configuration without its control cycles: what the
        # observations and the restarts take of a launch
        out[f'B={b},kernel_H_no_cycles,M={MULTI_M}'] = kernel_h_ms(MULTI_M, b, device, num_cycles=0)
    return out


PLAN_WIDTHS = (4096, 8192, 16384, 32768, 65536)
_BOX = {'shape': 'box', 'size': [0.09, 0.08]}
#: 1-mover planning configurations kernels F and G are timed on (chip_smoke.py's): name -> (layout, collision)
PLAN_CONFIGS = {
    'circle_full': (((1, 1, 1), (1, 1, 1), (1, 1, 1)), None),
    'box_full': (((1, 1, 1), (1, 1, 1), (1, 1, 1)), _BOX),
    'circle_holed': (((1, 1, 1), (1, 1, 0), (1, 1, 1)), None),
    'box_holed': (((1, 1, 0), (1, 1, 1), (0, 1, 1)), _BOX),
}


def planning_rollout_state(b: int, seed: int, device: str = 'cuda:0', config: str = 'circle_full', steps: int = 8):
    """(config, params, state) of a ``PLAN_CONFIGS`` configuration (the
    default one: bench.py:213): ``init_batch``, then ``steps`` fused
    autoreset steps of uniform random actions in [-10, 10]."""
    import numpy as np

    from gymnasium_planar_robotics_tpu_torch.models import planning

    layout, coll = PLAN_CONFIGS[config]
    cfg, prm = planning.make_planning_env(np.array(layout), 1, collision_params=coll, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = planning.init_batch(cfg, prm, b, g)
    step = planning.make_fused_step_autoreset(cfg, prm)
    for _ in range(steps):
        state = step(state, (torch.rand((b, 2), generator=g, device=device) * 2 - 1) * 10.0, generator=g)[0]
    return cfg, prm, state


def planning_kernel_ms(widths=PLAN_WIDTHS, configs=tuple(PLAN_CONFIGS), device: str = 'cuda:0',
                       launches: int = 100) -> dict:
    """Kernels F and G's device ms per launch (Philox, seed 7; G at K = 32;
    ``launch_device_ms``) at each width and configuration, on
    ``planning_rollout_state``, in both block shapes where the tree's
    wrapper has ``uses_producer``, else in the wrapper's."""
    from gymnasium_planar_robotics_tpu_torch.models import planning
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan

    split = hasattr(kplan, 'uses_producer')
    shapes = {'thread_per_env': 0, 'producer': 1} if split else {'wrapper': None}
    out = {}
    for name in configs:
        for b in widths:
            cfg, prm, state = planning_rollout_state(b, 40, device, name)
            kc = kplan.make_kernel_consts(cfg, prm)
            st = planning.state_to_planes(cfg, state)
            g = torch.Generator(device=device).manual_seed(41)
            acts = ((torch.rand((KS[-1], 2, b), generator=g, device=device) * 2 - 1) * 10.0).contiguous()
            cell = {'F_ms': {}, 'G_ms': {}}
            for label, producer in shapes.items():
                with forced_shape(kplan, producer) if producer is not None else contextlib.nullcontext():
                    # device time from the profiler: F's launch is shorter than the host's enqueue of it
                    cell['F_ms'][label] = launch_device_ms(
                        lambda: kplan.planning_autoreset_cuda(st, acts[0], kc, None, 7), launches)
                    cell['G_ms'][label] = launch_device_ms(
                        lambda: kplan.planning_rollout_cuda(st, acts, kc, None, 7), max(launches // 10, 3))
            if split:
                # a parent tree's switch takes ``rollout``, this tree's the kernel's name
                named = switches_cycles(kplan)
                cell['wrapper_producer'] = {'F': kplan.uses_producer(b, kc, 'autoreset' if named else False),
                                            'G': kplan.uses_producer(b, kc, 'rollout' if named else True)}
            out[f'{name},B={b}'] = cell
    return out


def planning_rates(repeats: int, profile: bool = False, device: str = 'cuda:0') -> dict:
    from gymnasium_planar_robotics_tpu_torch.models import planning

    out = {}
    for b in WIDTHS:
        cfg, prm, state = planning_rollout_state(b, 4, device, steps=0)
        g = torch.Generator(device=device).manual_seed(5)
        acts = (torch.rand((T_ROLL, b, 2), generator=g, device=device) * 2 - 1) * 10.0
        for k in KS:
            roll = planning.make_fused_rollout(cfg, prm, steps_per_launch=k)
            timings = [time_ms(lambda: roll(state, acts, 3), 3) for _ in range(repeats)]
            runs = [b * T_ROLL / (ms / 1e3) for ms, _ in timings]
            med = statistics.median(runs)
            cell = {'env_steps_per_s': runs, 'median': med, 'spread': (max(runs) - min(runs)) / med,
                    'host_ms_per_rollout': [host for _, host in timings],
                    'host_share': [min(host / ms, 1.0) for ms, host in timings]}
            if profile:
                cell['profile'] = device_profile(lambda: roll(state, acts, 3))
            out[f'B={b},K={k}'] = cell
    return out


def pushing_rollout_state(b: int, seed: int, device: str = 'cuda:0', box: bool = False, steps: int = 8):
    """(config, params, state) of the default pushing env (``box``: the box
    collision shape of ``chip_smoke.py``, bench.py:653-655): ``init_batch``,
    then ``steps`` fused autoreset steps of uniform random actions in [-10,
    10]."""
    from gymnasium_planar_robotics_tpu_torch.models import pushing

    kw = {'collision_params': {'shape': 'box', 'size': [0.09, 0.09]}} if box else {}
    cfg, prm = pushing.make_pushing_env(device=device, **kw)
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = pushing.init_batch(cfg, prm, b, g)
    step = pushing.make_fused_step_autoreset(cfg, prm)
    for _ in range(steps):
        state = step(state, (torch.rand((b, 2), generator=g, device=device) * 2 - 1) * 10.0, generator=g)[0]
    return cfg, prm, state


def step_ms(step, state, b: int, device: str, iters: int = 50) -> dict:
    """The ms a step of a public ``make_fused_step`` from ``state`` (uniform
    random actions in [-10, 10], a card generator), CUDA events over
    ``iters`` steps, with the host's ms to enqueue one and its share."""
    g = torch.Generator(device=device).manual_seed(6)
    acts = (torch.rand((iters + 1, b, 2), generator=g, device=device) * 2 - 1) * 10.0
    it = iter(range(iters + 1))
    ms, host = time_ms(lambda: step(state, acts[next(it)], generator=g), iters)
    return {'ms': ms, 'host_ms': host, 'host_share': min(host / ms, 1.0)}


def cycles_kernel_ms(widths=PLAN_WIDTHS, configs=tuple(PLAN_CONFIGS), device: str = 'cuda:0',
                     launches: int = 100) -> dict:
    """Kernel A's device ms per launch at the main path's shape, kernels B
    (circle and box) and E (``configs``) at each width in both block shapes
    where the tree's wrapper switches them (``switches_cycles``), else in the
    wrapper's (Philox, seed 7; ``launch_device_ms``), and the public fused
    steps of both families at 4096 envs (``step_ms``)."""
    from gymnasium_planar_robotics_tpu_torch.models import planning, pushing
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

    b_main = WIDTHS[0]
    u = torch.rand((6, b_main), generator=torch.Generator(device=device).manual_seed(42), device=device)
    out = {'A': {'injected': launch_device_ms(lambda: noise.noise_probe_cuda(3, b_main, device, uniforms=u), launches),
                 'philox': launch_device_ms(lambda: noise.noise_probe_cuda(3, b_main, device, seed=7), launches)}}

    def both_shapes(module, launch) -> dict:
        if not switches_cycles(module):
            return {'wrapper': launch_device_ms(launch, launches)}
        res = {}
        for label, producer in (('thread_per_env', 0), ('producer', 1)):
            with forced_shape(module, producer):
                res[label] = launch_device_ms(launch, launches)
        return res

    for box in (False, True):
        for b in widths:
            cfg, prm, state = pushing_rollout_state(b, 43, device, box)
            kc = kpush.make_kernel_consts(cfg, prm, 32)
            act = (torch.rand((2, b), generator=torch.Generator(device=device).manual_seed(44), device=device) * 2
                   - 1) * 10.0
            planes = torch.cat([pushing.state_to_planes(state)[:16], act]).contiguous()
            cell = both_shapes(kpush, lambda: kpush.pushing_cycles_cuda(planes, kc, None, 7))
            if switches_cycles(kpush):
                cell['wrapper_producer'] = kpush.uses_producer(b, kc, 'cycles')
            out[f"B{'_box' if box else ''},B={b}"] = cell
    for name in configs:
        for b in widths:
            cfg, prm, state = planning_rollout_state(b, 40, device, name)
            kc = kplan.make_kernel_consts(cfg, prm)
            act = (torch.rand((2, b), generator=torch.Generator(device=device).manual_seed(41), device=device) * 2
                   - 1) * 10.0
            planes = torch.cat([planning.state_to_planes(cfg, state)[:6], act]).contiguous()
            cell = both_shapes(kplan, lambda: kplan.planning_cycles_cuda(planes, kc, None, 7))
            if switches_cycles(kplan):
                cell['wrapper_producer'] = kplan.uses_producer(b, kc, 'cycles')
            out[f'E,{name},B={b}'] = cell
    cfg, prm, state = pushing_rollout_state(b_main, 45, device)
    out['pushing_fused_step'] = step_ms(pushing.make_fused_step(cfg, prm), state, b_main, device)
    cfg, prm, state = planning_rollout_state(b_main, 46, device)
    out['planning_fused_step'] = step_ms(planning.make_fused_step(cfg, prm), state, b_main, device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--label', default='')
    ap.add_argument('--repeats', type=int, default=5)
    ap.add_argument('--profile', action='store_true', help='also trace one rollout per cell')
    ap.add_argument('--family', choices=('pushing', 'multi', 'layouts', 'many', 'planning', 'cycles', 'all'),
                    default='all',
                    help="'layouts': kernel H in every lane layout (a tree whose kernel H takes them); 'many': "
                         "kernel H on the ladder states (ladder_state) at --movers and --widths, in the wrapper's "
                         "layout or (--every-layout) in each; 'cycles': kernels A, B and E, and "
                         "the public fused steps")
    ap.add_argument('--movers', default=None,
                    help="'layouts': comma-separated mover counts (keys of MULTI_TABLES, the default); 'many': any "
                         "(default 129,256)")
    ap.add_argument('--every-layout', action='store_true', help="'many': every layout, the many-mover variant forced")
    ap.add_argument('--configs', default=','.join(PLAN_CONFIGS),
                    help="'planning', 'cycles': comma-separated configurations of the kernel timings (keys of "
                         "PLAN_CONFIGS)")
    ap.add_argument('--widths', default=None,
                    help="'layouts', 'many', 'planning', 'cycles': comma-separated env counts of the kernel timings "
                         f"(default {','.join(map(str, WIDTHS))}, 4096 and {','.join(map(str, PLAN_WIDTHS))})")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device')
        return 2
    import gymnasium_planar_robotics_tpu_torch as pkg

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    out = {'label': args.label, 'package': pkg.__file__, 'card': card, 'T': T_ROLL}
    if args.family in ('pushing', 'all'):
        out['rates'] = rates(args.repeats, args.profile)
    if args.family in ('multi', 'all'):
        out['multi'] = multi_rates(args.repeats, args.profile)
    widths = tuple(int(b) for b in args.widths.split(',')) if args.widths else None
    if args.family in ('layouts', 'all'):
        movers = args.movers or ','.join(map(str, MULTI_TABLES))
        out['layouts'] = kernel_h_layouts(tuple(int(m) for m in movers.split(',')), widths or WIDTHS)
    if args.family == 'many':
        out['many'] = kernel_h_many_ms(tuple(int(m) for m in (args.movers or '129,256').split(',')), widths or (4096,),
                                       args.every_layout)
    if args.family in ('planning', 'all'):
        out['planning'] = planning_rates(args.repeats, args.profile)
        out['planning_kernels'] = planning_kernel_ms(widths or PLAN_WIDTHS, tuple(args.configs.split(',')))
    if args.family in ('cycles', 'all'):
        out['cycles_kernels'] = cycles_kernel_ms(widths or PLAN_WIDTHS, tuple(args.configs.split(',')))
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
