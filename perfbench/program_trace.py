"""The program's own spans and restart counters (the port's
``utils/profiling``: ``gprt.rollout``, ``gprt.launch``, ``gprt.policy``;
``restarts``, ``stalled``, ``trials``), read in a traced run.

The harness's profiled stretch runs with the program's tracing off, so it
enqueues the program's device work as an untraced call does.  The metrics
that read the program's spans and counters take them from two stretches
made here once a run (``readings``), after the harness's, on a driver of
the cell built anew from the run's seeds (the harness has released its
own by then), each of as many calls as the harness's profiled stretch:

- a profiled stretch (on the card only), the program's spans on beside
  the benchmark's and its counters off: ``parse`` reads its trace as
  ``tracing.parse`` does and adds ``program`` (the ``gprt.*``
  annotations) and ``device_program`` (the innermost program span open at
  each device operation's launch, in the order of ``device``);
- a span stretch, spans and counters on and no profiler, read at its end
  by ``profiling.read_spans`` and ``read_counters``.

A program without these spans (its ``utils/profiling`` has no ``enable``)
gives nothing to read: ``readings`` returns None and runs no stretch.  A
run from the command line writes the readings to
``perfbench_runs/<cell>-<seed>-t1-program.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

import harness
import manifest
import stats
import tracing

PROFILING = 'gymnasium_planar_robotics_tpu_torch.utils.profiling'
PREFIX = 'gprt.'
ROLLOUT, LAUNCH, POLICY = 'gprt.rollout', 'gprt.launch', 'gprt.policy'


def _profiling():
    """The program's tracing module, or None where it has no spans."""
    try:
        mod = importlib.import_module(PROFILING)
    except ImportError:
        return None
    return mod if all(hasattr(mod, f) for f in ('enable', 'disable', 'read_spans', 'read_counters')) else None


def parse(events: list) -> dict:
    """``tracing.parse`` of a Chrome trace's events, and ``program``
    ``[(start, end, name)]`` (the program's spans) and ``device_program``
    (for each entry of ``device``, the innermost program span open at its
    launch, or None)."""
    parsed = tracing.parse(events)
    program, host_of, device = [], {}, []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, args = e.get('cat', ''), e.get('args') or {}
        ts, dur = float(e['ts']) * 1e-6, float(e.get('dur', 0.0)) * 1e-6
        if cat == 'user_annotation' and str(e.get('name', '')).startswith(PREFIX):
            program.append((ts, ts + dur, e['name']))
        elif cat in tracing.HOST_CATS and 'correlation' in args:
            host_of[args['correlation']] = ts
        elif cat in tracing.DEVICE_CATS:
            device.append((ts, args.get('correlation')))
    parsed['program'] = sorted(program)
    parsed['device_program'] = tracing.innermost_at(program, [host_of.get(c, ts) for ts, c in device])
    return parsed


def _take(run_calls, takes: int = tracing.TAKES):
    """``tracing.take`` with ``parse``: the profiled stretch's parsed trace,
    or None where every take came back without device records."""
    out_dir = manifest.ROOT / 'perfbench_runs'
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / 'program-trace.json'
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(takes):
        with torch.profiler.profile(activities=activities) as prof:
            run_calls()
        prof.export_chrome_trace(str(path))
        try:
            parsed = parse(json.loads(path.read_text())['traceEvents'])
        finally:
            path.unlink(missing_ok=True)
        if parsed['device']:
            return parsed
    return None


def span_table(records: list) -> dict:
    """Spans by name: ``count``, ``total_ms`` and ``self_ms`` (the span less
    its direct children)."""
    done = [r for r in records if r[2] is not None]
    children = {}
    for name, s, e, parent, _ in done:
        if parent is not None:
            children[parent] = children.get(parent, 0) + (e - s)
    table: dict = {}
    for i, (name, s, e, _, _) in enumerate(records):
        if e is None:
            continue
        row = table.setdefault(name, {'count': 0, 'total_ms': 0.0, 'self_ms': 0.0})
        row['count'] += 1
        row['total_ms'] += (e - s) * 1e-6
        row['self_ms'] += (e - s - children.get(i, 0)) * 1e-6
    return table


def idle_gaps(parsed: dict) -> dict:
    """The profiled stretch's idle time by ``<benchmark span>/<program
    span>``, the innermost of each open at the gap's middle."""
    lo, hi = tracing.window(parsed)
    holes = stats.gaps([(s, e) for s, e, *_ in parsed['device']], lo, hi)
    mids = [(s + e) / 2 for s, e in holes]
    out: dict = {}
    for (s, e), b, p in zip(holes, tracing.innermost_at(parsed['spans'], mids),
                            tracing.innermost_at(parsed['program'], mids)):
        key = f'{b or "none"}/{p or "none"}'
        out[key] = out.get(key, 0.0) + (e - s)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _command_line() -> tuple:
    """The run's cell and seed where it came from ``run.py``; else (None, 0)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument('--workload')
    ap.add_argument('--seed', type=int, default=0)
    try:
        args, _ = ap.parse_known_args(sys.argv[1:])
    except SystemExit:
        return None, 0
    return args.workload, args.seed


def _measure(ctx: dict) -> dict | None:
    prof = _profiling()
    if prof is None or ctx['traced_counts'] is None:
        return None
    device = torch.device('cuda' if ctx['kernel_load_s'] is not None else 'cpu')
    cell, seed = _command_line()
    spans = tracing.Spans()
    driver = importlib.import_module(f'traffic.{ctx["mix"]["kind"]}').Driver(
        ctx['config'], ctx['mix'], device, harness.seeds(seed), spans)
    driver.setup()
    n = len(ctx['traced_counts'])

    def one_call(i: int) -> None:
        with spans('call'):
            with spans('actions'):
                inputs = driver.draw(i)
            with spans('env_step'):
                out = driver.call(i, inputs)
            with spans('readback'):
                driver.readback(out)

    def stretch(base: int, traced: bool) -> float:
        spans.enabled = traced
        prof.enable(spans=True, counters=not traced)
        t0 = time.perf_counter()
        try:
            for k in range(n):
                one_call(base + k)
        finally:
            prof.disable()
            spans.enabled = False
        return time.perf_counter() - t0

    for i in range(harness.WARMUP_CALLS):
        one_call(i)
    base = harness.WARMUP_CALLS
    parsed = _take(lambda: stretch(base, True)) if device.type == 'cuda' else None
    seconds = stretch(base + n, False)  # each call ends on its readback's synchronise
    table, counters = span_table(prof.read_spans()), prof.read_counters()
    driver.release()

    steps = n * ctx['steps_per_call']
    glue = None
    if parsed is not None:
        glue = sum(e - s for (s, e, *_), p in zip(parsed['device'], parsed['device_program']) if p == ROLLOUT)
    res = {
        'calls': n, 'steps': steps, 'spans': table, 'counters': counters,
        'env_steps_per_s': {'span_stretch': steps * ctx['envs'] / seconds,
                            'window': len(ctx['timer']) * ctx['steps_per_call'] * ctx['envs'] / ctx['window_s']},
        'glue_device_s': glue, 'idle_gaps_program': idle_gaps(parsed) if parsed is not None else None,
    }
    if cell is not None:
        out_dir = manifest.ROOT / 'perfbench_runs'
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f'{cell}-{seed}-t1-program.json').write_text(json.dumps(res, indent=1))
    return res


def readings(ctx: dict) -> dict | None:
    """The two stretches' readings, made at the first metric's read and
    kept in ``ctx``; None where the program has no spans."""
    if 'program' not in ctx:
        ctx['program'] = _measure(ctx)
    return ctx['program']


def per_step_ms(ctx: dict, name: str, key: str = 'total_ms'):
    """Span ``name``'s ``key`` over the span stretch's steps, or None."""
    r = readings(ctx)
    row = r and r['spans'].get(name)
    return row[key] / r['steps'] if row else None
