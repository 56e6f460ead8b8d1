"""One run of one cell: set-up, a closed loop of collection calls for the
window, an optional traced stretch, the check against the reference, and
the result line.

One collection call is ``steps_per_call`` env-steps of the whole batch: it
draws its inputs (the actions, or the policy's exploration noise), runs the
program's rollout from the state the last call left, and reads back the
call's reward sum and its counts of finished and collided env-steps, as a
learner consumes a batch; that read ends the call with a synchronise.  The
Philox seed of call ``i`` is the run's kernel seed plus ``i *
steps_per_call``, so every call draws fresh noise.

``run`` takes any device, so the tests rehearse it on the CPU with the
program's plain versions; ``main`` insists on the card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import check
import manifest
import stats
import tracing

#: top-level module names a run may not hold (compared whole: the program's
#: name begins with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gymnasium_planar_robotics_tpu')
#: calls of set-up that warm up the cell's shapes (the first is checked)
WARMUP_CALLS = 2
#: the checked window call is drawn from the seed among the window's first calls
CHECK_WITHIN = 20
#: the least length of a traced run's profiled stretch
TRACED_SECONDS = 1.0


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (from
    ``/proc/self/stat``'s start time; the interpreter's first import of
    this module where that cannot be read)."""
    try:
        ticks = int(Path('/proc/self/stat').read_text().rsplit(')', 1)[1].split()[19])
        uptime = float(Path('/proc/uptime').read_text().split()[0])
        age = uptime - ticks / os.sysconf('SC_CLK_TCK')
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def seeds(seed: int) -> dict:
    """The run's independent seeds, drawn from ``--seed``: the kernels'
    Philox base, the traffic's draws, the reset's draws, the weights."""
    if seed < 0:
        raise ValueError(f'--seed is a whole number >= 0, got {seed}')
    words = np.random.SeedSequence(seed).generate_state(5, np.uint64)
    kernel, data, init, weights, sample = (int(w) >> 2 for w in words)
    return {'kernel': kernel, 'data': data, 'init': init, 'weights': weights, 'sample': sample}


def forbidden_modules() -> list[str]:
    return sorted({name.split('.')[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,clocks.max.sm',
                              '--format=csv,noheader'], capture_output=True, text=True, timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f'nvidia-smi: {exc}'


def run(name: str, seed: int, seconds: float, trace: bool, device: str = 'cuda', root: Path = manifest.ROOT,
        overrides: dict | None = None, out_dir: Path | None = None) -> dict:
    """One run of cell ``name``; returns the result (the last line's
    object, with ``checks``) and a record of what the line leaves out under
    ``'record'``.  ``overrides`` replaces entries of the traffic mix (the
    tests' small batches)."""
    t_start = process_start()
    bench = manifest.load(root)
    spec = manifest.cell(bench, name, root)
    mix = dict(spec['mix'], **(overrides or {}))
    cfg = spec['config']
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = seeds(seed)
    spans = tracing.Spans()
    record: dict = {'cell': name, 'seed': seed, 'mix': mix}

    kernel_load_s = None
    if dev.type == 'cuda':
        from gymnasium_planar_robotics_tpu_torch.ops.kernels import build
        t0 = time.perf_counter()
        build.lib()
        kernel_load_s = time.perf_counter() - t0
        record['build'] = {k: v for k, v in build.build_info.items() if k != 'log'}
    driver = importlib.import_module(f'traffic.{mix["kind"]}').Driver(cfg, mix, dev, sd, spans)
    init_batch_ms = driver.setup()
    ref = importlib.import_module(f'reference.{cfg["family"]}')
    record['start'] = check.start(ref, cfg, driver.initial)

    steps, envs = mix['steps_per_call'], mix['envs']
    rng = np.random.default_rng(sd['sample'])
    warmup = WARMUP_CALLS
    sampled = warmup + int(rng.integers(0, CHECK_WITHIN))
    keep = {0, sampled}
    captures: dict = {}

    def one_call(i: int, timer: list | None = None):
        with spans('call'):
            t0 = time.perf_counter()
            with spans('actions'):
                inputs = driver.draw(i)
            state_in = driver.state
            with spans('env_step'):
                out = driver.call(i, inputs)
            t_enq = time.perf_counter()
            with spans('readback'):
                got = driver.readback(out)
            t1 = time.perf_counter()
        if timer is not None:
            timer.append((t0, t_enq, t1))
        if i in keep:
            captures[i] = driver.capture(i, state_in, inputs, out)
        return got, (state_in, inputs, out)

    for i in range(warmup):
        one_call(i)
    t_first = time.monotonic()
    setup_s = t_first - t_start
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    timer: list = []
    last = None
    i = warmup
    w0 = time.perf_counter()
    while True:
        _, last = one_call(i, timer)
        i += 1
        if timer[-1][2] - w0 >= seconds:
            break
    window_s = timer[-1][2] - w0
    n_calls = i - warmup
    if sampled not in captures:  # the window ended first: check its last call
        captures[i - 1] = driver.capture(i - 1, *last)
    record['window'] = {'calls': n_calls, 'seconds': window_s}

    parsed = None
    if trace:
        lat = statistics.median(t1 - t0 for t0, _, t1 in timer)
        n_traced = max(3, int(np.ceil(TRACED_SECONDS / lat)))
        base = i

        def traced():
            spans.enabled = True
            try:
                res = [one_call(base + k)[0] for k in range(n_traced)]
            finally:
                spans.enabled = False
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            return res

        parsed, takes, traced_counts = tracing.take(traced, out_dir or root / 'perfbench_runs')
        record['traced'] = {'calls': n_traced, 'takes': takes}
        if parsed is None and dev.type == 'cuda':
            raise RuntimeError(f'the profiler handed back no device records in {takes} takes')
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    launches = {}
    if dev.type == 'cuda':
        from gymnasium_planar_robotics_tpu_torch.ops import kernels
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    record['launches'] = launches
    driver.release()
    t_ref = time.perf_counter()

    # the check: once the window has closed and the program's state is freed
    numbers = check.numbers(ref, cfg, mix, captures, record['start'], lower=False)
    record['check_s'] = time.perf_counter() - t_ref
    record['checked_calls'] = sorted(captures)
    limits = spec['cell']['limits']
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    failed_checks = [k for k, v in checks.items() if not v['value'] <= v['limit']]
    correct = not failed_checks

    ctx = {
        'mix': mix, 'config': cfg, 'costs': spec['costs'], 'steps_per_call': steps, 'envs': envs,
        'timer': timer, 'window_s': window_s, 'init_batch_ms': init_batch_ms, 'kernel_load_s': kernel_load_s,
        'parsed': parsed, 'traced_counts': traced_counts if trace else None,
        'peaks': json.loads((root / manifest.HERE.name / 'peaks.json').read_text()),
    }
    metrics = {}
    if trace:
        for m in spec['per_layer']:
            value = importlib.import_module(f'metrics.{m["name"]}').read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        lat_ms = [(t1 - t0) * 1e3 for t0, _, t1 in timer]
        e2e = {'env_steps_per_s': n_calls * steps * envs / window_s,
               'rollout_ms_p95': stats.percentile(lat_ms, 95.0), 'setup_s': setup_s}
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']} for m in spec['end_to_end']}
        record['latency_ms'] = {'median': statistics.median(lat_ms), 'p95': e2e['rollout_ms_p95'],
                                'max': max(lat_ms), 'calls': len(lat_ms)}
    dev_info = {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
                'kind': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
                'count': spec['entry']['chips'] if dev.type == 'cuda' else 1,
                'memory_peak_bytes': memory_peak}
    result = {'correct': correct, 'attempted': n_calls, 'failed': len(failed_checks), 'metrics': metrics,
              'device': dev_info}
    if parsed is not None:
        lo, hi = tracing.window(parsed)
        dev_info['busy_s'] = stats.busy([(s, e) for s, e, *_ in parsed['device']], lo, hi)
        dev_info['window_s'] = hi - lo
        record['traced_idle_share'] = 100.0 * (1.0 - dev_info['busy_s'] / dev_info['window_s'])
        result['breakdown'] = check.breakdown(parsed, lo, hi)
    result['checks'] = checks
    record.update(setup_s=setup_s, init_batch_ms=init_batch_ms, kernel_load_s=kernel_load_s,
                  memory_peak_bytes=memory_peak, checks=checks)
    result['record'] = record
    return result


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description='Run one cell of BENCHMARK.json once on the card.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    entry = next((w for w in bench['workloads'] if w['name'] == args.workload), None)
    if entry is None:
        print(f'no cell {args.workload!r} in BENCHMARK.json', file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry['chips']:
        print(f'cell {args.workload} needs {entry["chips"]} CUDA device(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2
    out_dir = manifest.ROOT / 'perfbench_runs'
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), 'cuda', out_dir=out_dir)
    record = result.pop('record')
    record['card'] = card_line()
    record['torch'] = f'{torch.__version__} cuda {torch.version.cuda}'
    bad = forbidden_modules()
    if bad:
        print(f'the run loaded {bad}: the benchmark measures the port alone', file=sys.stderr)
        return 3
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f'{args.workload}-{args.seed}-t{args.trace}.json'
    path.write_text(json.dumps(dict(record, result=result), indent=1, default=str))
    print(f'record: {path.relative_to(manifest.ROOT)}; card: {record["card"]}')
    for k, v in result['checks'].items():
        print(f'check {k}: {v["value"]!r} limit {v["limit"]!r}', file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
