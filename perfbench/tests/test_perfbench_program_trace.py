"""The readers of the program's own spans and counters
(``program_trace``, the five per-layer metrics on it): the trace reading on
synthetic Chrome traces, each reader on a synthetic context, and a whole
traced run on the CPU (the program's plain versions)."""

import importlib
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import check  # noqa: E402
import harness  # noqa: E402
import program_trace  # noqa: E402
import tracing  # noqa: E402
from test_perfbench_stats import _ev, synthetic_trace  # noqa: E402

METRICS = ('rollout_self_host_ms_per_step', 'launch_host_us', 'policy_host_ms_per_step', 'rollout_glue_ms_per_step',
           'restart_trials_per_restart')


def annotated_trace():
    """``synthetic_trace`` with the program's spans: a rollout inside each
    ``env_step``, a policy step and a kernel call inside it, and one
    operation (at 150 us) launched by the rollout's own code."""
    ev = synthetic_trace()
    for c, t in enumerate((0.0, 1000.0)):
        k = 10 * c
        ev += [_ev('gprt.rollout', 'user_annotation', t + 12, 690), _ev('gprt.policy', 'user_annotation', t + 18, 110),
               _ev('gprt.launch', 'user_annotation', t + 190, 20),
               _ev('cudaLaunchKernel', 'cuda_runtime', t + 150, 1, correlation=k + 5),
               _ev('where', 'kernel', t + 160, 30, correlation=k + 5)]
    return ev


def test_program_annotations_leave_the_existing_readings_unchanged():
    plain = tracing.parse(synthetic_trace())
    # the same trace with the program's spans, and one more operation outside them
    bare = [e for e in annotated_trace() if not e['name'].startswith('gprt.')]
    for events in (annotated_trace(), bare):
        ours, theirs = program_trace.parse(events), tracing.parse(events)
        for key in ('spans', 'launches', 'device'):
            assert ours[key] == theirs[key]
        lo, hi = tracing.window(theirs)
        assert check.breakdown(ours, lo, hi) == check.breakdown(theirs, lo, hi)
    assert tracing.parse(annotated_trace())['spans'] == plain['spans']
    ours = program_trace.parse(annotated_trace())
    assert [n for *_, n in ours['program']] == ['gprt.rollout', 'gprt.policy', 'gprt.launch'] * 2
    by_op = {d[2]: p for d, p in zip(ours['device'], ours['device_program'])}
    assert by_op == {'rand': None, 'gemm': 'gprt.policy', 'where': 'gprt.rollout', 'env_kernel': 'gprt.launch',
                     'Memcpy DtoH': None}
    assert program_trace.parse(bare)['program'] == [] and set(program_trace.parse(bare)['device_program']) == {None}


def test_idle_gaps_are_keyed_by_both_spans():
    parsed = program_trace.parse(annotated_trace())
    gaps = program_trace.idle_gaps(parsed)
    # each call: 25-40 us in both policy spans, 140-160 in the rollout's own code, 190-210 in the launch
    assert gaps['policy/gprt.policy'] == pytest.approx(2 * 15e-6)
    assert gaps['env_step/gprt.rollout'] == pytest.approx(2 * 20e-6)
    assert gaps['env_step/gprt.launch'] == pytest.approx(2 * 20e-6)


def test_span_table_takes_the_children_from_the_self_time():
    recs = [('gprt.rollout', 0, 10_000_000, None, 0), ('gprt.launch', 1_000_000, 2_000_000, 0, 0),
            ('gprt.policy', 3_000_000, 6_000_000, 0, 0), ('gprt.launch', 7_000_000, 8_000_000, 0, 0),
            ('gprt.launch', 9_000_000, None, 0, 0)]
    t = program_trace.span_table(recs)
    assert t['gprt.rollout'] == {'count': 1, 'total_ms': pytest.approx(10.0), 'self_ms': pytest.approx(5.0)}
    assert t['gprt.launch'] == {'count': 2, 'total_ms': pytest.approx(2.0), 'self_ms': pytest.approx(2.0)}


def _read(name, ctx):
    return importlib.import_module(f'metrics.{name}').read(ctx)


def test_each_reader_on_a_synthetic_context():
    spans = {'gprt.rollout': {'count': 2, 'total_ms': 20.0, 'self_ms': 4.0},
             'gprt.launch': {'count': 128, 'total_ms': 3.2, 'self_ms': 3.2},
             'gprt.policy': {'count': 128, 'total_ms': 12.8, 'self_ms': 12.8}}
    program = {'steps': 128, 'spans': spans, 'counters': {'restarts': 40, 'stalled': 2, 'trials': 100},
               'glue_device_s': 2.56e-3}
    got = {m: _read(m, {'program': program}) for m in METRICS}
    assert got == pytest.approx({'rollout_self_host_ms_per_step': 4.0 / 128, 'launch_host_us': 25.0,
                                 'policy_host_ms_per_step': 0.1, 'rollout_glue_ms_per_step': 0.02,
                                 'restart_trials_per_restart': 2.5})
    bare = dict(program, spans={'gprt.rollout': spans['gprt.rollout'], 'gprt.launch': spans['gprt.launch']},
                counters={'restarts': 0, 'stalled': 0, 'trials': 0}, glue_device_s=None)
    assert _read('policy_host_ms_per_step', {'program': bare}) is None
    assert _read('restart_trials_per_restart', {'program': bare}) is None
    assert _read('rollout_glue_ms_per_step', {'program': bare}) is None
    for m in METRICS:
        assert _read(m, {'program': None}) is None


def test_a_program_without_spans_gives_nothing_to_read(monkeypatch):
    monkeypatch.setattr(program_trace, 'PROFILING', 'json')  # a module without ``enable``
    ctx = {'traced_counts': [(0.0, 0, 0)] * 3}
    assert [_read(m, ctx) for m in METRICS] == [None] * len(METRICS)
    assert ctx['program'] is None


@pytest.mark.parametrize('cell, overrides', [('push-reactive-64k', {'envs': 8, 'steps_per_call': 8}),
                                             ('plan4-open-k1-64k', {'envs': 16, 'steps_per_call': 8})])
def test_a_traced_run_on_the_cpu_reads_the_program_spans(cell, overrides):
    res = harness.run(cell, 2**33 + 5, 0.01, True, 'cpu', overrides=overrides)
    metrics = res['metrics']
    assert res['correct']
    assert metrics['rollout_self_host_ms_per_step']['value'] > 0 and metrics['launch_host_us']['value'] > 0
    assert ('policy_host_ms_per_step' in metrics) == (cell == 'push-reactive-64k')
    assert 'rollout_glue_ms_per_step' not in metrics  # no device records on the CPU
    if 'restart_trials_per_restart' in metrics:
        assert metrics['restart_trials_per_restart']['value'] >= (2.0 if cell.startswith('plan') else 1.0)
