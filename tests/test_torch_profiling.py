"""The program's spans and restart counters (``utils/profiling``) on the
CPU, over the rollouts' plain versions.

- With spans on, one call of each rollout records one ``gprt.rollout``
  span, a ``gprt.launch`` span per kernel call and (reactive) a
  ``gprt.policy`` span per step, each with its parent and the call's id.
- With spans off nothing is recorded or allocated, and no ``gprt.*``
  annotation shows in a ``torch.profiler`` trace; with spans on and
  counters off the trace holds the same operations as with tracing off.
- The outputs are bit-identical with tracing on and off.
- The counters equal the sums of the kernels' own ``stalled`` and
  ``trials`` rows over a step-by-step run of ``make_fused_step_autoreset``
  with the same seeds.
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.utils import profiling

B, T, SEED = 24, 4, 11


@pytest.fixture(autouse=True)
def _tracing_off():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.enable(spans=False, counters=False)  # off, and nothing recorded
    yield
    profiling.disable()
    torch.set_num_threads(prev)


def constant_policy(action):
    def policy_step(pol, gen, obs_pm):
        return action.expand(2, obs_pm.shape[1]), ()

    return policy_step


def _env(family: str, movers: int = 1):
    kw = dict(std_noise=1e-5, num_cycles=4, device='cpu')
    if family == 'pushing':
        return tpush, *tpush.make_pushing_env(**kw)
    return tplan, *tplan.make_planning_env(np.ones((4, 4)), movers, **kw)


def _state(mod, cfg, prm, b=B):
    state, _, _ = mod.init_batch(cfg, prm, b, torch.Generator().manual_seed(3))
    state.steps[::3] = cfg.max_episode_steps - 2  # truncation restarts inside the call
    return state


def _actions(cfg, b=B, t=T):
    m = getattr(cfg, 'num_movers', 1)
    return (torch.rand((t, b, m, 2), generator=torch.Generator().manual_seed(5)) * 2 - 1).reshape(t, b, -1) * 4.0


#: name -> (family, movers, reactive, steps_per_launch): launches per call
ROLLOUTS = {
    'push-k1': ('pushing', 1, False, 1),
    'push-k3': ('pushing', 1, False, 3),
    'push-reactive': ('pushing', 1, True, 1),
    'plan1-k1': ('planning', 1, False, 1),
    'plan1-k3': ('planning', 1, False, 3),
    'plan1-reactive': ('planning', 1, True, 1),
    'plan4': ('planning', 4, False, 1),
}


def _call(name: str):
    """One call of rollout ``name`` from a fixed state: its outputs, flat."""
    family, movers, reactive, k = ROLLOUTS[name]
    mod, cfg, prm = _env(family, movers)
    state = _state(mod, cfg, prm)
    if reactive:
        pol = constant_policy(torch.tensor([[2.0], [1.0]]))
        final, traj, last = mod.make_reactive_rollout(cfg, prm, pol, T, cand_k=2)(state, None, None, SEED)
        return [*vars(final).values(), *[x for x in traj if isinstance(x, torch.Tensor)], last]
    final, *rest = mod.make_fused_rollout(cfg, prm, cand_k=2, steps_per_launch=k)(state, _actions(cfg), SEED)
    return [*vars(final).values(), *rest]


@pytest.mark.parametrize('name', sorted(ROLLOUTS))
def test_spans_of_one_rollout_call(name):
    _, _, reactive, k = ROLLOUTS[name]
    profiling.enable(counters=False)
    _call(name)
    spans = profiling.read_spans()
    names = [s[0] for s in spans]
    assert names[0] == profiling.ROLLOUT and names.count(profiling.ROLLOUT) == 1
    assert names.count(profiling.LAUNCH) == -(-T // k)
    assert names.count(profiling.POLICY) == (T if reactive else 0)
    root = spans[0]
    assert root[3] is None and root[4] == 0
    for s in spans[1:]:
        assert s[3] == 0 and s[4] == 0  # every launch and policy step directly inside the call
        assert root[1] <= s[1] <= s[2] <= root[2]
    # a second call gets its own id
    _call(name)
    spans = profiling.read_spans()
    second = [i for i, s in enumerate(spans) if s[0] == profiling.ROLLOUT][1]
    assert {s[4] for s in spans[second:]} == {second}


@pytest.mark.parametrize('name', ['push-reactive', 'plan4'])
def test_spans_off_leave_no_trace_and_add_no_operation(name):
    def traced_ops():
        with profiling.trace() as prof:
            _call(name)
        return [e.name for e in prof.events()]

    _call(name)  # the process's first call fills the kernels' caches of constants
    off = traced_ops()
    assert profiling.read_spans() == [] and profiling.TRACER.counts == {}
    assert not [n for n in off if n.startswith('gprt.')]
    profiling.enable(counters=False)
    on = traced_ops()
    assert {n for n in on if n.startswith('gprt.')} >= {profiling.ROLLOUT, profiling.LAUNCH}
    assert [n for n in on if not n.startswith('gprt.')] == off
    assert profiling.TRACER.counts == {}


def test_span_off_is_one_shared_context():
    assert profiling.span('gprt.x') is profiling.OFF
    with profiling.span('gprt.x') as s:
        assert s is None
    assert profiling.read_spans() == []


def test_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, 'MAX_SPANS', 3)
    profiling.enable()
    _call('push-k1')
    spans = profiling.read_spans()
    assert len(spans) == 3 and profiling.TRACER.dropped == 1 + T - 3
    assert [s[0] for s in spans] == [profiling.ROLLOUT, profiling.LAUNCH, profiling.LAUNCH]
    assert all(s[2] is not None for s in spans) and profiling.TRACER.stack == []


@pytest.mark.parametrize('name', sorted(ROLLOUTS))
def test_outputs_are_bit_identical_with_tracing_on_and_off(name):
    off = _call(name)
    profiling.enable()
    on = _call(name)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _stepwise_counts(family: str, movers: int) -> dict:
    """The kernels' own rows summed over a step-by-step run with the
    rollout's seeds: restarts (trials > 0), stalled, trials."""
    mod, cfg, prm = _env(family, movers)
    state, acts = _state(mod, cfg, prm), _actions(cfg)
    step = mod.make_fused_step_autoreset(cfg, prm, cand_k=2)
    sums = dict.fromkeys(profiling.COUNTERS, 0)
    for t in range(T):
        planes = mod.state_to_planes(state) if family == 'pushing' else mod.state_to_planes(cfg, state)
        state, _, _, _, _, info = step(state, acts[t], seed=SEED + t,
                                       generator=common.seeded_generator(planes, SEED + t))
        trials = info['reset_trials'].to(torch.int64)
        sums['restarts'] += int((trials > 0).sum())
        sums['stalled'] += int(info['reset_stalled'].sum())
        sums['trials'] += int(trials.sum())
    return sums


@pytest.mark.parametrize('name', ['push-k1', 'plan4', 'plan1-k1'])
def test_counters_equal_the_kernels_rows(name):
    family, movers, _, _ = ROLLOUTS[name]
    want = _stepwise_counts(family, movers)
    assert want['restarts'] > 0 and want['trials'] >= want['restarts']
    profiling.enable(spans=False)
    _call(name)
    assert profiling.read_spans() == []
    assert profiling.read_counters() == want
    _call(name)
    assert profiling.read_counters() == {k: 2 * v for k, v in want.items()}


@pytest.mark.parametrize('family', ['pushing', 'planning'])
def test_reactive_counters_equal_the_fused_rollouts(family):
    """A constant policy drives the same kernel with the same seeds as the
    fused rollout at K=1 (bit for bit), so both count the same restarts."""
    mod, cfg, prm = _env(family)
    action = torch.tensor([[2.0], [1.0]])
    profiling.enable(spans=False)
    mod.make_reactive_rollout(cfg, prm, constant_policy(action), T, cand_k=2)(_state(mod, cfg, prm), None, None,
                                                                               SEED)
    reactive = profiling.read_counters()
    profiling.enable(spans=False)
    acts = action.T.expand(T, B, 2)
    mod.make_fused_rollout(cfg, prm, cand_k=2)(_state(mod, cfg, prm), acts, SEED)
    assert reactive == profiling.read_counters() and reactive['restarts'] > 0


def test_k_step_rollouts_count_nothing():
    profiling.enable()
    _call('push-k3')
    _call('plan1-k3')
    assert profiling.read_counters() == dict.fromkeys(profiling.COUNTERS, 0)
