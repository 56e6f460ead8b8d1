"""A whole run on the CPU (the program's plain versions, the harness's look
for a card skipped) with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have, and true without one.

Faults: a step that returns its state unchanged; half of the batch left
out (its state unchanged, its flags cleared); an answer altered where it
is produced (a flag or count every env reports); in the reactive cell also
the action the policy hands the env altered; in the planning cell also a
count altered in one env of a hundred.  The cells run on one chip,
so there is no exchange between chips to leave out."""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402

from gymnasium_planar_robotics_tpu_torch.models import ppo  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush  # noqa: E402

SMALL = {'envs': 8, 'steps_per_call': 8}


def _pushing_step(fault):
    orig = kpush.pushing_autoreset

    def step(state, action, kc, **kw):
        res = orig(state, action, kc, **kw)
        out = (res[0] if isinstance(res, tuple) else res).clone()
        half = state.shape[1] // 2
        if fault == 'unchanged':
            out[:19] = state
        elif fault == 'half':
            out[:19, half:] = state[:, half:]
            out[33:, half:] = 0.0
        elif fault == 'altered':
            out[33] = 1.0 - out[33]
        return (out, res[1]) if isinstance(res, tuple) else out

    return 'pushing_autoreset', step


def _pushing_chunk(fault):
    orig = kpush.pushing_rollout

    def chunk(state, actions, kc, **kw):
        final, sig = (x.clone() for x in orig(state, actions, kc, **kw))
        half = state.shape[1] // 2
        if fault == 'unchanged':
            final = state.clone()
        elif fault == 'half':
            final[:, half:] = state[:, half:]
            sig[:, :, half:] = 0.0
        elif fault == 'altered':
            sig[0] = 1.0 - sig[0]
        return final, sig

    return 'pushing_rollout', chunk


def _planning_step(fault):
    orig = kmulti.planning_multi_autoreset

    def step(state, action, mc, **kw):
        out = orig(state, action, mc, **kw).clone()
        n, half = state.shape[0], state.shape[1] // 2
        m = mc.m
        if fault == 'unchanged':
            out[:n] = state
        elif fault == 'half':
            out[:n, half:] = state[:, half:]
            out[18 * m + 1:18 * m + 4, half:] = 0.0
        elif fault == 'altered':
            out[18 * m + 3] = out[18 * m + 3] + 1.0
        elif fault == 'few':
            few = max(1, state.shape[1] // 100)
            out[18 * m + 3, :few] = out[18 * m + 3, :few] + 1.0
        return out

    return 'planning_multi_autoreset', step


PATCH = {'push-open-k32-4k': (kpush, _pushing_chunk), 'plan4-open-k1-64k': (kmulti, _planning_step),
         'push-reactive-64k': (kpush, _pushing_step)}
CASES = [(cell, fault) for cell in PATCH for fault in ('unchanged', 'half', 'altered')]


def _run(cell, overrides=SMALL):
    torch.set_num_threads(2)
    res = harness.run(cell, 20240501, 0.01, False, 'cpu', overrides=overrides)
    return res['correct'], res['checks']


@pytest.mark.parametrize('cell', list(PATCH))
def test_a_sound_run_is_correct(cell):
    correct, checks = _run(cell)
    assert correct, checks


@pytest.mark.parametrize('cell,fault', CASES)
def test_a_broken_step_is_caught(cell, fault, monkeypatch):
    module, make = PATCH[cell]
    name, broken = make(fault)
    monkeypatch.setattr(module, name, broken)
    correct, checks = _run(cell)
    assert not correct, checks


def test_an_altered_action_is_caught(monkeypatch):
    orig = ppo.sample_action_pm

    def altered(policy, obs, noise, scale):
        action, raw, logp, value = orig(policy, obs, noise, scale)
        return -action, raw, logp, value

    monkeypatch.setattr(ppo, 'sample_action_pm', altered)
    correct, checks = _run('push-reactive-64k')
    assert not correct, checks


def test_a_fault_in_one_env_of_a_hundred_is_caught(monkeypatch):
    """Kernel H is bit-equal to its plain version, so every sound
    planning run reads no env apart: a fault confined to a rare path, here
    one env in a hundred with a count altered, fails the cell's limit."""
    name, broken = _planning_step('few')
    monkeypatch.setattr(kmulti, name, broken)
    correct, checks = _run('plan4-open-k1-64k', {'envs': 200, 'steps_per_call': 4})
    assert not correct, checks
    assert checks['env_diverged']['value'] == pytest.approx(0.01)
