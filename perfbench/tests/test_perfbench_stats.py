"""The benchmark's arithmetic on synthetic numbers: the p95, the idle
share and the reading of a trace into spans."""

import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import check  # noqa: E402
import importlib  # noqa: E402
import stats  # noqa: E402
import tracing  # noqa: E402


@pytest.mark.parametrize('n', [1, 2, 7, 200, 1001])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).exponential(30.0, n))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_busy_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (9.0, 12.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.busy(iv, 1.0, 10.0) == pytest.approx(1.0 + 1.0 + 1.0)
    assert stats.gaps(iv, 1.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def _ev(name, cat, ts, dur, **args):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur, 'args': args}


def synthetic_trace():
    """Two calls: each draws actions, steps the env (a policy span inside
    it launching a GEMM, then the env kernel) and reads back."""
    ev = []
    for c, t in enumerate((0.0, 1000.0)):
        ev += [_ev('call', 'user_annotation', t, 900), _ev('actions', 'user_annotation', t + 1, 9),
               _ev('env_step', 'user_annotation', t + 10, 700), _ev('policy', 'user_annotation', t + 20, 100),
               _ev('readback', 'user_annotation', t + 720, 170)]
        k = 10 * c
        ev += [_ev('cudaLaunchKernel', 'cuda_runtime', t + 2, 1, correlation=k + 1),
               _ev('cudaLaunchKernel', 'cuda_runtime', t + 30, 1, correlation=k + 2),
               _ev('cudaLaunchKernel', 'cuda_runtime', t + 200, 1, correlation=k + 3),
               _ev('cudaMemcpyAsync', 'cuda_runtime', t + 730, 1, correlation=k + 4)]
        ev += [_ev('rand', 'kernel', t + 5, 20, correlation=k + 1), _ev('gemm', 'kernel', t + 40, 100, correlation=k + 2),
               _ev('env_kernel', 'kernel', t + 210, 500, correlation=k + 3),
               _ev('Memcpy DtoH', 'gpu_memcpy', t + 740, 10, correlation=k + 4)]
    return ev


def test_trace_reading_attributes_device_time_to_spans():
    parsed = tracing.parse(synthetic_trace())
    assert tracing.window(parsed) == pytest.approx((0.0, 1900e-6))
    assert tracing.device_seconds(parsed, 'policy') == pytest.approx(200e-6)
    assert tracing.device_seconds(parsed, 'env_step') == pytest.approx(1000e-6)
    assert tracing.device_seconds(parsed, 'actions') == pytest.approx(40e-6)
    assert tracing.launches_in(parsed, *tracing.window(parsed)) == 6
    lo, hi = tracing.window(parsed)
    busy = stats.busy([(s, e) for s, e, *_ in parsed['device']], lo, hi)
    assert busy == pytest.approx(2 * (20 + 100 + 500 + 10) * 1e-6)
    bd = check.breakdown(parsed, lo, hi)
    assert bd['device_ops'][0] == ['env_kernel', pytest.approx(1000e-6)]
    idle = dict(bd['idle_gaps'])
    # gaps in the env_step span: 25-40 (in policy, 20-120), 140-210, 710-720 (the span ends at 710)
    assert idle['policy'] == pytest.approx(2 * 15e-6)
    assert sum(idle.values()) == pytest.approx(hi - lo - busy)
    assert len(bd['device_ops']) <= 10 and len(bd['idle_gaps']) <= 10


def test_idle_share_sets_the_traced_busy_time_against_the_untraced_window():
    parsed = tracing.parse(synthetic_trace())
    idle = importlib.import_module('metrics.device_idle_share')
    # 630 us busy a traced call; ten window calls in 7 ms leave 10% idle
    ctx = {'parsed': parsed, 'traced_counts': [(0.0, 0, 0)] * 2, 'timer': [(0.0, 0.0, 0.0)] * 10, 'window_s': 7e-3}
    assert idle.read(ctx) == pytest.approx(10.0)
    assert idle.read(dict(ctx, parsed=None)) is None
