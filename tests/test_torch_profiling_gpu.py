"""The program's spans and restart counters on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX; on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_profiling_gpu.py -q

- With spans on and counters off, a rollout makes the same kernel launches
  (the profiler's launch calls and ``kernels.LAUNCHES``) as with tracing
  off, and its outputs are bit-identical with tracing on and off.
- The counters equal the sums of the kernels' own ``stalled`` and
  ``trials`` rows over a step-by-step run of ``make_fused_step_autoreset``
  with the same Philox seeds (kernels C and H).
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.utils import profiling

B, T, SEED = 4096, 8, 2**40 + 7

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    profiling.enable(spans=False, counters=False)
    yield torch.device('cuda')
    profiling.disable()


def _env(family: str, device, movers: int = 1):
    if family == 'pushing':
        return tpush, *tpush.make_pushing_env(device=device)
    return tplan, *tplan.make_planning_env(np.ones((4, 4)), movers, device=device)


def _state(mod, cfg, prm, device):
    state, _, _ = mod.init_batch(cfg, prm, B, torch.Generator(device=device).manual_seed(3))
    state.steps[::5] = cfg.max_episode_steps - 3  # truncation restarts inside the call
    return state


def _actions(cfg, device):
    m = getattr(cfg, 'num_movers', 1)
    g = torch.Generator(device=device).manual_seed(5)
    return (torch.rand((T, B, 2 * m), generator=g, device=device) * 2 - 1) * 8.0


def _reactive_policy(obs_dim: int):
    w = torch.linspace(-1.0, 1.0, 2 * obs_dim, device='cuda').reshape(2, obs_dim)

    def policy_step(pol, gen, obs_pm):
        return torch.tanh(w @ obs_pm) * 8.0, ()

    return policy_step


def _call(name: str, device):
    if name == 'push-reactive':
        mod, cfg, prm = _env('pushing', device)
        roll = mod.make_reactive_rollout(cfg, prm, _reactive_policy(12), T)
        final, traj, last = roll(_state(mod, cfg, prm, device), None, None, SEED)
        return [*vars(final).values(), *[x for x in traj if isinstance(x, torch.Tensor)], last]
    family, movers, k = {'push-k1': ('pushing', 1, 1), 'push-k4': ('pushing', 1, 4),
                         'plan4': ('planning', 4, 1)}[name]
    mod, cfg, prm = _env(family, device, movers)
    final, *rest = mod.make_fused_rollout(cfg, prm, steps_per_launch=k)(_state(mod, cfg, prm, device),
                                                                        _actions(cfg, device), SEED)
    return [*vars(final).values(), *rest]


@pytest.mark.parametrize('name', ['push-k1', 'push-k4', 'push-reactive', 'plan4'])
def test_spans_add_no_launch_and_tracing_changes_no_output(cuda, name):
    def traced():
        before = dict(kernels.LAUNCHES)
        with profiling.trace() as prof:
            out = _call(name, cuda)
            torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        return out, profiling.trace_summary(prof)['launch_calls'], launches, [e.name for e in prof.events()]

    _call(name, cuda)  # warm up
    off, calls_off, launches_off, names_off = traced()
    assert not [n for n in names_off if n.startswith('gprt.')]
    profiling.enable(counters=False)
    on, calls_on, launches_on, names_on = traced()
    assert calls_on == calls_off and launches_on == launches_off
    assert profiling.ROLLOUT in names_on and profiling.read_counters() == dict.fromkeys(profiling.COUNTERS, 0)
    profiling.enable()
    counted = _call(name, cuda)
    for a, b, c in zip(off, on, counted):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize('family, movers', [('pushing', 1), ('planning', 4)])
def test_counters_equal_the_kernels_rows_on_the_card(cuda, family, movers):
    mod, cfg, prm = _env(family, cuda, movers)
    state, acts = _state(mod, cfg, prm, cuda), _actions(cfg, cuda)
    step = mod.make_fused_step_autoreset(cfg, prm)
    trials, stalled = [], []
    for t in range(T):
        state, _, _, _, _, info = step(state, acts[t], seed=SEED + t)
        trials.append(info['reset_trials'].to(torch.int64))
        stalled.append(info['reset_stalled'])
    trials, stalled = torch.stack(trials), torch.stack(stalled)
    want = {'restarts': int((trials > 0).sum()), 'stalled': int(stalled.sum()), 'trials': int(trials.sum())}
    assert want['restarts'] > 0
    profiling.enable(spans=False)
    mod.make_fused_rollout(cfg, prm)(_state(mod, cfg, prm, cuda), acts, SEED)
    assert profiling.read_counters() == want
