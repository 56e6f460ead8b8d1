"""Pushing's fused rollout rates on the card, in env-steps/s.

Times ``pushing.make_fused_rollout`` over 64 steps at K = 1 (kernel C once
a step) and K = 32 (kernel D), at 4096 and 65,536 envs, as
``chip_smoke.py``'s ``rollout_rate`` phase does, ``--repeats`` times each,
and prints one JSON line: every repeat's rate, their median and their spread
((max - min) / median) and the host's time to enqueue each rollout, with the
card's name and power limit.  With ``--profile`` each cell also runs one
rollout under ``torch.profiler`` and reports the card's busy time in it and
each kernel's device ms per launch.  Each width also reports kernel C alone
(``launch_cost``): the host's time to enqueue a launch and the card's time
per launch back to back.

It imports the package from wherever Python finds it, so two trees can be
compared on one card by running this file with each tree on ``PYTHONPATH``
in turn, alternating (a, b, b, a)::

    PYTHONPATH=path/to/tree python gymnasium_planar_robotics_tpu_torch/tools/rollout_rates.py --label tree
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--label', default='')
    ap.add_argument('--repeats', type=int, default=5)
    ap.add_argument('--profile', action='store_true', help='also trace one rollout per cell')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device')
        return 2
    import gymnasium_planar_robotics_tpu_torch as pkg

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({'label': args.label, 'package': pkg.__file__, 'card': card, 'T': T_ROLL,
                      'rates': rates(args.repeats, args.profile)}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
