"""Port parity: ``tools/transfer_eval.py``'s in-engine half and
``utils/trajstore.native_available``.

- The scripted pursuit policy equals the JAX package's on 4096 seeded
  vectors (some with the acceleration capped at ``a_max``, some not):
  float64, rtol 1e-6 / atol 1e-6; float32, atol 1e-5, as its
  ``60 * (target - mover)`` carries 60 ulp of a position (3.6e-6), which
  XLA's contractions round apart from the port's eager ops.
- Each PPO policy closure (planning, pushing) equals the JAX closure's
  expression ``jnp.clip(ppo.apply(pol, vec)[0], -a_max, a_max)`` (pushing on
  its features) on the same JAX ``init_params`` carried over by
  ``ppo.params_from_numpy`` (the mean head's bias set to +-``a_max``, so
  that the clip bites), rtol 1e-5 / atol 1e-6.
- Each trainer hands ``ppo.make_train_step`` the JAX function's
  ``PPOConfig``, the same family's ``step_autoreset``, features equal to
  JAX's, and makes its envs with the JAX function's kwargs (captured by
  patches at ``iters=1``); two iterations of each at 8 envs on the CPU give
  finite metrics, a policy that acts, and the sparse eval config.
- The scripted policy's in-engine eval in both packages (256 episodes, CPU):
  ``success_any`` within 4 standard errors of the difference.
- ``run_family('pushing-scripted', ...)`` and ``main`` end to end.
- ``native_available()`` is True with ``g++`` and False, without raising,
  when ``CXX`` names a missing compiler.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import transfer_eval as jte  # noqa: E402
from gymnasium_planar_robotics_tpu.models import planning as jplan  # noqa: E402
from gymnasium_planar_robotics_tpu.models import ppo as jppo  # noqa: E402
from gymnasium_planar_robotics_tpu.models import pushing as jpush  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.models import ppo as tppo  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.tools import transfer_eval as tte  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.utils import trajstore  # noqa: E402

TRAINERS = {'planning': ('train_planning', 'make_planning_env'), 'pushing-ppo': ('train_pushing_ppo',
                                                                               'make_pushing_env')}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _vectors(n: int, seed: int) -> np.ndarray:
    """``[n, 8]`` pushing vectors: mover, its velocity, object, goal; in half
    of them the mover sits near its stand-off point and barely moves (the
    acceleration under ``a_max``)."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.uniform(0.0, 0.72, (n, 2)), rng.normal(0.0, 0.5, (n, 2)),
                        rng.uniform(0.1, 0.62, (n, 2)), rng.uniform(0.1, 0.62, (n, 2))], -1)
    h = n // 2
    to_goal = v[:h, 6:8] - v[:h, 4:6]
    push = to_goal / np.maximum(np.linalg.norm(to_goal, axis=-1, keepdims=True), 1e-6)
    v[:h, :2] = v[:h, 4:6] - 0.11 * push + rng.normal(0.0, 0.02, (h, 2))
    v[:h, 2:4] = rng.normal(0.0, 0.1, (h, 2))
    v[h:h + 4, 6:8] = v[h:h + 4, 4:6]  # the object at its goal
    return v.astype(np.float32)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_scripted_policy_matches_jax(dtype):
    vec = _vectors(4096, 0).astype(dtype)
    want = np.asarray(jte.scripted_pursuit_policy()[0](jnp.asarray(vec)))
    policy, (cfg, prm) = tte.scripted_pursuit_policy('cpu')
    got = policy(torch.from_numpy(vec)).numpy()
    norms = np.linalg.norm(want, axis=-1)
    assert (norms < 9.99).sum() > 500 and (norms > 9.99).sum() > 500  # both branches
    assert got.dtype == want.dtype == np.dtype(dtype)
    # float32: the stand-off offset 60 (target - mover) of positions up to
    # 0.72 m carries 60 ulp(0.72) = 3.6e-6, rounded apart where XLA contracts
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 if dtype == 'float64' else 1e-5)
    assert cfg.reward_mode == 'sparse' and float(prm.a_max) == jte.PUSHING_KW['a_max']


@pytest.mark.parametrize('family', ['planning', 'pushing-ppo'])
def test_ppo_policy_closures_match_jax(family):
    planning = family == 'planning'
    a_max = (jte.PLANNING_KW if planning else jte.PUSHING_KW)['a_max']
    cfg = jppo.PPOConfig(obs_dim=6 if planning else 12, action_dim=2, hidden=(64, 64) if planning else (256, 256))
    tree = jax.tree_util.tree_map(np.asarray, jppo.init_params(jax.random.PRNGKey(3), cfg))
    tree['mu']['w'] = tree['mu']['w'] * 10.0
    tree['mu']['b'] = np.array([a_max, -a_max], np.float32)  # so that the clip bites about half the time
    jpol = jax.tree_util.tree_map(jnp.asarray, tree)
    tpol = tppo.params_from_numpy(tree, device='cpu')
    rng = np.random.default_rng(4)
    if planning:
        vec = rng.uniform(0.0, 0.72, (2048, 6)).astype(np.float32)
        want = np.asarray(jnp.clip(jppo.apply(jpol, jnp.asarray(vec))[0], -a_max, a_max))
        got = tte.planning_policy(tpol, a_max)(torch.from_numpy(vec)).numpy()
    else:
        vec = _vectors(2048, 5)
        j = jnp.asarray(vec)
        want = np.asarray(jnp.clip(jppo.apply(jpol, jte._pushing_vec(j[..., :4], j[..., 4:6], j[..., 6:8]))[0],
                                   -a_max, a_max))
        got = tte.pushing_ppo_policy(tpol, a_max)(torch.from_numpy(vec)).numpy()
    assert (np.abs(want) == a_max).mean() > 0.1 and (np.abs(want) < a_max).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _capture(monkeypatch, te, ppo_mod, model, make_env: str, zeros):
    """Patches ``te``'s ``ppo.make_train_step`` (recording its arguments,
    handing back a train step that only records its calls) and the family's
    ``make_env`` (recording its kwargs)."""
    seen = {'envs': [], 'steps': 0}
    real_env, real_step = getattr(model, make_env), ppo_mod.make_train_step

    def env(*args, **kw):
        kept = {k: v for k, v in kw.items() if k not in ('dtype', 'device')}
        seen['envs'].append(([np.asarray(a).tolist() for a in args], kept))
        return real_env(*args, **kw)

    def make_train_step(config, params, cfg, step_fn, obs_to_vec=None, **kw):
        seen.update(cfg=dataclasses.asdict(cfg), step=step_fn, obs_to_vec=obs_to_vec)
        _, opt = real_step(config, params, cfg, step_fn, obs_to_vec=obs_to_vec, **kw)

        def train_step(runner):
            seen['steps'] += 1
            return runner, {'reward_mean': zeros()}

        return train_step, opt

    monkeypatch.setattr(model, make_env, env)
    monkeypatch.setattr(ppo_mod, 'make_train_step', make_train_step)
    return seen


@pytest.mark.parametrize('family', list(TRAINERS))
def test_trainer_configs_match_jax(monkeypatch, family):
    fn, make_env = TRAINERS[family]
    jmodel, tmodel = (jplan, tplan) if family == 'planning' else (jpush, tpush)
    jseen = _capture(monkeypatch, jte, jte.ppo, jmodel, make_env, lambda: jnp.zeros(()))
    getattr(jte, fn)(iters=1, batch=8, seed=0, log=None)
    tseen = _capture(monkeypatch, tte, tte.ppo, tmodel, make_env, lambda: torch.zeros(()))
    getattr(tte, fn)(iters=1, batch=8, seed=0, log=None, device='cpu')
    assert tseen['cfg'] == jseen['cfg']
    assert tseen['envs'] == jseen['envs'] and len(tseen['envs']) == 2  # the training env, then the eval env
    assert tseen['steps'] == jseen['steps'] == 1
    assert tseen['step'] is tmodel.step_autoreset and jseen['step'] is jmodel.step_autoreset
    assert (tseen['obs_to_vec'] is None) == (jseen['obs_to_vec'] is None) == (family == 'planning')
    if family != 'planning':
        rng = np.random.default_rng(6)
        obs = {'observation': rng.normal(size=(5, 4)), 'achieved_goal': rng.normal(size=(5, 2)),
               'desired_goal': rng.normal(size=(5, 2))}
        want = np.asarray(jseen['obs_to_vec']({k: jnp.asarray(v, jnp.float32) for k, v in obs.items()}))
        got = tseen['obs_to_vec']({k: torch.tensor(v, dtype=torch.float32) for k, v in obs.items()}).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('family', list(TRAINERS))
def test_trainers_run_two_iterations(monkeypatch, family):
    metrics = []
    real = tppo.make_train_step

    def spy(*a, **kw):
        step, opt = real(*a, **kw)

        def train_step(runner):
            runner, m = step(runner)
            metrics.append({k: float(v) for k, v in m.items()})
            return runner, m

        return train_step, opt

    monkeypatch.setattr(tppo, 'make_train_step', spy)
    logs, timings = [], {}
    policy, (cfg, prm) = getattr(tte, TRAINERS[family][0])(iters=2, batch=8, seed=1, log=logs.append, device='cpu',
                                                           timings=timings)
    assert len(metrics) == 2 and all(math.isfinite(v) for m in metrics for v in m.values())
    assert len(timings['iter_ms']) == 2 and len(logs) == 2
    assert cfg.reward_mode == 'sparse'
    vec = torch.from_numpy(_vectors(16, 7)[:, :6 if family == 'planning' else 8])
    act = policy(vec)
    assert act.shape == (16, 2) and bool(torch.isfinite(act).all()) and float(act.abs().max()) <= float(prm.a_max)


def test_scripted_eval_in_engine_matches_jax():
    n = 256
    policy, (cfg, prm) = jte.scripted_pursuit_policy()
    want = jte.eval_in_engine(jpush, cfg, prm, policy, n, seed=100)
    policy, (cfg, prm) = tte.scripted_pursuit_policy('cpu')
    got = tte.eval_in_engine(tpush, cfg, prm, policy, n, seed=100)
    p, q = got['success_any'], want['success_any']
    se = math.sqrt((p * (1 - p) + q * (1 - q)) / n)
    assert abs(p - q) <= 4 * se, (got, want)
    assert min(p, q) > 0.08 and got['episodes'] == n  # it pushes: well above the ~3% whose object starts at its goal


def test_run_family_and_main():
    logs = []
    res = tte.run_family('pushing-scripted', 8, None, 0, log=logs.append, device='cpu')
    assert res['family'] == 'pushing-scripted' and set(res) == {'family', 'engine'}
    assert res['engine']['episodes'] == 512 and 0.0 <= res['engine']['success'] <= res['engine']['success_any']
    assert json.loads(logs[-1]) == res
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = tte.main(['--families', 'pushing-scripted', '--device', 'cpu'])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith('{')]
    assert lines == results == [res]  # the default 512 episodes, seed 0: the same eval
    with pytest.raises(SystemExit):
        tte.main(['--families', 'reference'])


def test_native_available(monkeypatch):
    assert shutil.which('g++')
    assert trajstore.native_available()
    monkeypatch.setattr(trajstore, '_lib', None)
    monkeypatch.setenv('CXX', os.path.join(os.sep, 'nonexistent', 'g++'))
    assert trajstore.native_available() is False
