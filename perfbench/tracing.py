"""Spans around the benchmark's calls into the program, and the profiler's
trace of a stretch of calls read back into device intervals, launches and
the host span each fell in.

The spans are ``torch.profiler.record_function`` ranges the benchmark
opens itself: ``call`` around one collection call, and inside it
``actions`` (drawing its actions or exploration noise), ``env_step`` (the
program's rollout), ``policy`` (the policy step the benchmark hands to a
reactive rollout; inside ``env_step``) and ``readback`` (reading the call's
rewards, which ends it with a synchronise).  Outside a traced stretch they
cost nothing: ``Spans.enabled`` is false and each is a null context.

A device operation belongs to the innermost span open on the host when its
launch was enqueued (the runtime call with its correlation id).  The
profiler now and then hands back no device records at all; such a take is
made again, up to ``TAKES`` times, and a stretch without records reads as
nothing, never as zero.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from pathlib import Path

import torch

SPANS = ('call', 'actions', 'env_step', 'policy', 'readback')
#: the calls that launch a kernel: the CUDA runtime's (cuda*) and its low-level API's (cu*)
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel', 'cuLaunchKernelEx')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cuda_runtime', 'cuda_driver')
TAKES = 3


class Spans:
    """Named host spans, recorded only while ``enabled``."""

    def __init__(self):
        self.enabled = False

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def _innermost(spans: list, times: list) -> list:
    """For each host time (sorted ascending), the name of the innermost
    span open at it, or None.  ``spans``: ``(start, end, name)`` properly
    nested, as one thread's ranges are."""
    spans = sorted(spans)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def parse(events: list) -> dict:
    """A Chrome trace's events read into ``spans`` ``[(start, end, name)]``,
    ``launches`` (host times of kernel launch calls) and ``device``
    ``[(start, end, name, cat, span)]``, times in seconds; ``span`` is the
    innermost benchmark span open at the operation's launch."""
    spans, launches, host_of = [], [], {}
    device = []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, args = e.get('cat', ''), e.get('args') or {}
        ts, dur = float(e['ts']) * 1e-6, float(e.get('dur', 0.0)) * 1e-6
        if cat == 'user_annotation' and e.get('name') in SPANS:
            spans.append((ts, ts + dur, e['name']))
        elif cat in HOST_CATS:
            if 'correlation' in args:
                host_of[args['correlation']] = ts
            if e.get('name') in LAUNCH_CALLS:
                launches.append(ts)
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get('name', '?'), cat, args.get('correlation')))
    order = sorted(range(len(device)), key=lambda k: host_of.get(device[k][4], device[k][0]))
    named = _innermost(spans, [host_of.get(device[k][4], device[k][0]) for k in order])
    dev = [None] * len(device)
    for k, name in zip(order, named):
        s, e, n, c, _ = device[k]
        dev[k] = (s, e, n, c, name)
    return {'spans': sorted(spans), 'launches': sorted(launches), 'device': dev}


def innermost_at(spans: list, times: list) -> list:
    """``_innermost`` for times in any order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    names = _innermost(spans, [times[k] for k in order])
    out = [None] * len(times)
    for k, n in zip(order, names):
        out[k] = n
    return out


def take(run_calls, out_dir: Path, takes: int = TAKES):
    """Profile ``run_calls()`` (a stretch of calls that ends with a
    synchronise) and parse its trace; made again while the profiler hands
    back no device records, up to ``takes`` times.  Returns ``(parsed,
    takes made, what run_calls returned)``; ``parsed`` is None when every
    take came back empty."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / 'trace.json'
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    result = None
    for n in range(1, takes + 1):
        with torch.profiler.profile(activities=activities) as prof:
            result = run_calls()
        prof.export_chrome_trace(str(path))
        try:
            parsed = parse(json.loads(path.read_text())['traceEvents'])
        finally:
            path.unlink(missing_ok=True)
        if parsed['device']:
            return parsed, n, result
    return None, takes, result


def window(parsed: dict) -> tuple[float, float]:
    """The traced window: from the first call's start to the last call's end."""
    calls = [(s, e) for s, e, n in parsed['spans'] if n == 'call']
    return min(s for s, _ in calls), max(e for _, e in calls)


def launches_in(parsed: dict, lo: float, hi: float) -> int:
    ls = parsed['launches']
    return bisect.bisect_right(ls, hi) - bisect.bisect_left(ls, lo)


def device_seconds(parsed: dict, span: str, cats=('kernel',)) -> float:
    """Summed device time of the operations launched inside ``span`` (the
    innermost span open at the launch)."""
    return sum(e - s for s, e, _, cat, name in parsed['device'] if name == span and cat in cats)


def traced_env_steps(ctx: dict) -> int:
    """Env-steps of the traced stretch: its calls times the steps a call."""
    return len(ctx['traced_counts']) * ctx['steps_per_call']
