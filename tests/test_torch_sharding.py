"""Port parity: ``parallel/sharding.py`` on gloo ranks against the JAX
package's ``make_sharded_fused_step`` and against the port unsharded.

The ranks are processes (``tests/torch_sharding_worker.py``: torch and the
port only) that meet on a ``FileStore`` in the test's temporary directory:
two ranks for every scenario, four for the 1-mover fused step (the sharded
PPO example runs on two in ``test_torch_examples.py``).  The JAX half runs here, while they run, on meshes cut
from the conftest's eight virtual CPU devices; inputs and outputs cross as
``.npz``.

- The sharded fused step (1-mover planning, pushing, 4 movers; 256 envs,
  4 cycles, ``cand_k=2``, injected uniforms for the global batch), gathered
  over the ranks, equals the port's unsharded step bit for bit and the JAX
  package's sharded step on a 2-device mesh (1-mover planning, pushing) or
  its fused step (4 movers: the JAX sharded step of kernel H does not finish
  in interpret mode on the virtual devices) at the tolerances of the
  unsharded fused-step parity tests (``test_torch_planning_autoreset.py``,
  ``test_torch_pushing_autoreset.py``): rtol 2e-6 / atol 2e-6, the
  acceleration and activation leaves rtol 1e-4 / atol 1e-5, flags, counters
  and the sparse rewards exact.
- ``sharded_step_fn`` on the eager step (``tests/test_sharding.py:34-55``'s
  scenario at ``std_noise=0``): gathered, bit-equal to the unsharded step
  and within rtol 1e-10 / atol 1e-12 of the JAX package's (float64).
- The sharded rollouts (K=1 and K=32, pushing and planning) and the reactive
  rollout, on a global batch of two equal halves: rank r's shard is bit-equal
  to the unsharded function on it under ``seed + r * 2**20`` (the reactive
  rollout's policy on ``rank_generator``'s split), and the two ranks differ.
- ``metrics_summary`` equals JAX's on the gathered arrays (rtol 1e-6) with one
  ``all_reduce``; the sharded fused step makes no ``torch.distributed`` call.
- Sharded PPO, 2 iterations: the parameters are bit-identical on both ranks
  and within rtol 1e-4 / atol 1e-6 of a one-rank run on the global batch
  with the same draws (summation order differs).
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu.parallel import sharding as jsharding
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.parallel import sharding
import torch_sharding_cases as cases
from torch_planning_multi_cases import CASES as MULTI_CASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_sharding_worker.py')
TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
STRIDE = 1 << 20
MESH_CHECK = """
import torch, torch.distributed as dist
from gymnasium_planar_robotics_tpu_torch.parallel import sharding
assert not dist.is_initialized()
mesh = sharding.make_mesh('cpu')
assert dist.is_initialized() and dist.get_backend() == 'gloo' and mesh.size() == 1
x = torch.arange(6.0).reshape(3, 2)
assert torch.equal(sharding.shard_batch({'x': x}, mesh)['x'], x)
m = sharding.metrics_summary(torch.ones(4), torch.zeros(4, dtype=torch.bool),
                             {k: torch.ones(4, dtype=torch.bool) for k in ('is_success', 'mover_collision',
                                                                          'wall_collision')}, mesh)
assert float(m['reward_mean']) == 1.0 and float(m['terminated_rate']) == 0.0
print('mesh ok')
"""


def _launch(d, rank, world, mode):
    log = open(os.path.join(d, f'{mode}_rank{rank}.log'), 'w')
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    return subprocess.Popen([sys.executable, WORKER, str(rank), str(world), str(d), mode], stdout=log,
                            stderr=subprocess.STDOUT, cwd=ROOT, env=env), log


def _to_jax_state(module, arrays: dict, seed: int = 0):
    d = {k[len('state.'):]: jnp.asarray(v) for k, v in arrays.items() if k.startswith('state.')}
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    cls = jplan.PlanningState if module is jplan else jpush.PushingState
    return cls(**d, key=keys)


def _flat_jax(out) -> dict:
    state, obs, reward, term, trunc, info = out
    flat = {f'state.{f.name}': np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)
            if f.name != 'key'}
    flat.update({f'obs.{k}': np.asarray(v) for k, v in obs.items()})
    flat.update(reward=np.asarray(reward), terminated=np.asarray(term), truncated=np.asarray(trunc))
    for k, v in info.items():
        if isinstance(v, dict):
            flat.update({f'info.{k}.{kk}': np.asarray(vv) for kk, vv in v.items()})
        else:
            flat[f'info.{k}'] = np.asarray(v)
    return flat


def _jax_env(name):
    if name == 'planning_m1':
        return jplan, jplan.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float32, **cases.PLAN_KW)
    if name == 'pushing':
        return jpush, jpush.make_pushing_env(dtype=jnp.float32, **cases.PUSH_KW)
    layout, m, coll, jerk, _, _ = MULTI_CASES['circle_full_acc_m4']
    return jplan, jplan.make_planning_env(layout, m, dtype=jnp.float32, collision_params=coll, learn_jerk=jerk,
                                          **cases.PLAN_KW)


def _jax_step(name, arrays):
    """The JAX package's sharded fused step on a 2-device mesh (4 movers:
    its fused step), on the global batch with the injected uniforms."""
    module, (cfg, prm) = _jax_env(name)
    state = _to_jax_state(module, arrays)
    action, noise = jnp.asarray(arrays['action']), jnp.asarray(arrays['noise'])
    if name == 'planning_m4':
        step = module.make_fused_step_autoreset(cfg, prm, interpret=True, inject_noise=True, cand_k=cases.CAND_K)
        return _flat_jax(step(state, action, noise=noise)), None
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    step = jsharding.make_sharded_fused_step(module, cfg, prm, mesh, interpret=True, inject_noise=True,
                                             cand_k=cases.CAND_K)
    out = step(jsharding.shard_batch(state, mesh), jsharding.shard_batch(action, mesh),
               noise=jax.device_put(noise, NamedSharding(mesh, P(None, 'data'))))
    return _flat_jax(out), out


def _eager_inputs() -> dict:
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 2, std_noise=0.0, num_cycles=10, dtype=torch.float64,
                                       device='cpu')
    s = tplan.init_batch(cfg, prm, cases.EAGER_B, torch.Generator().manual_seed(0))[0]
    return {**{f'eager/state.{k}': v for k, v in tplan.state_to_numpy(s).items()},
            'eager/action': np.random.default_rng(1).uniform(-5.0, 5.0, (cases.EAGER_B, 4))}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('sharding')
    inputs = _eager_inputs()
    for name in cases.STEP_CASES:
        inputs.update({f'{name}/{k}': v for k, v in cases.step_inputs(name).items()})
    np.savez(d / 'inputs.npz', **inputs)
    procs = [_launch(d, r, 2, 'cases') for r in range(2)] + [_launch(d, r, 4, 'cases4') for r in range(4)]
    mesh_proc = subprocess.Popen([sys.executable, '-c', MESH_CHECK], cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=ROOT))

    # the JAX half, while the ranks run
    jax_out, jax_raw = {}, {}
    for name in cases.STEP_CASES:
        jax_out[name], jax_raw[name] = _jax_step(name, {k[len(name) + 1:]: v for k, v in inputs.items()
                                                      if k.startswith(name + '/')})
    ecfg, eprm = jplan.make_planning_env(np.ones((3, 3)), 2, std_noise=0.0, num_cycles=10, dtype=jnp.float64)
    estate = _to_jax_state(jplan, {k[len('eager/'):]: v for k, v in inputs.items() if k.startswith('eager/')})
    jax_out['eager'] = _flat_jax(jplan.batched_step(ecfg, eprm, estate, jnp.asarray(inputs['eager/action'])))
    _, _, rew, term, _, info = jax_raw['planning_m1']
    jax_out['summary'] = {k: np.asarray(v) for k, v in jsharding.metrics_summary(rew, term, info).items()}

    # the port's one-rank PPO runs on the global batch (the draws as the ranks')
    state, obs_vec = cases.ppo_state()
    one_rank = {'fused': cases.run_ppo(None, state, obs_vec, False, cases.ppo_noises())}
    saved = kernels.draw_uniforms
    kernels.draw_uniforms = cases.zero_uniforms
    try:
        one_rank['reactive'] = cases.run_ppo(None, state, obs_vec, True)
    finally:
        kernels.draw_uniforms = saved

    failed = []
    for (proc, log), (rank, mode) in zip(procs, [(r, 'cases') for r in range(2)] + [(r, 'cases4') for r in range(4)]):
        try:
            rc = proc.wait(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = 'timeout'
        log.close()
        if rc != 0:
            failed.append(f'{mode} rank {rank}: {rc}\n' + open(os.path.join(d, f'{mode}_rank{rank}.log')).read()[-3000:])
    assert not failed, '\n'.join(failed)
    out, err = mesh_proc.communicate(timeout=180)
    mesh_check = SimpleNamespace(returncode=mesh_proc.returncode, stdout=out, stderr=err)

    def load(mode, world):
        out = []
        for r in range(world):
            with np.load(d / f'{mode}_rank{r}.npz') as z:
                out.append(dict(z))
        return out

    return SimpleNamespace(inputs=inputs, jax=jax_out, r2=load('cases', 2), r4=load('cases4', 4), one_rank=one_rank,
                           mesh_check=mesh_check)


def _gather(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix + '/') and not k.endswith('dist_calls')]
    return {k[len(prefix) + 1:]: np.concatenate([r[k] for r in ranks]) for k in keys}


def _unsharded(name, inputs):
    model = cases.STEP_CASES[name][0]
    cfg, prm = cases.make_env(name)
    arrays = {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + '/')}
    step = model.make_fused_step_autoreset(cfg, prm, cand_k=cases.CAND_K)
    return cases.flat_step(step(cases.state_from(name, arrays), torch.from_numpy(arrays['action']),
                                noise=torch.from_numpy(arrays['noise'])))


def _check_against_jax(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in got.items():
        w = want[k].astype(v.dtype) if v.dtype != want[k].dtype and v.dtype.kind == 'f' else want[k]
        if v.dtype.kind in 'biu' or k in ('reward', 'terminated', 'truncated'):
            np.testing.assert_array_equal(v, w, err_msg=k)
        else:
            tol = TOL_ACC if k.endswith(('.acc', '.act')) else TOL
            np.testing.assert_allclose(v, w, **tol, err_msg=k)


@pytest.mark.parametrize('name', list(cases.STEP_CASES))
def test_sharded_fused_step_matches_jax_and_unsharded(runs, name):
    got = _gather(runs.r2, name)
    want = _unsharded(name, runs.inputs)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    _check_against_jax(got, runs.jax[name])
    # restarts fired and episodes ran on
    assert got['info.wall_collision'].any() and (got['state.steps'] == 0).any() and (got['state.steps'] > 0).any()


def test_sharded_fused_step_on_four_ranks(runs):
    got = _gather(runs.r4, 'planning_m1')
    for k, v in _unsharded('planning_m1', runs.inputs).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    _check_against_jax(got, runs.jax['planning_m1'])
    assert all(int(r['planning_m1/dist_calls']) == 0 for r in runs.r4)


def test_sharded_eager_step_matches_unsharded_and_jax(runs):
    got = _gather(runs.r2, 'eager')
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 2, std_noise=0.0, num_cycles=10, dtype=torch.float64,
                                       device='cpu')
    state = tplan.state_from_numpy({k[len('eager/state.'):]: v for k, v in runs.inputs.items()
                                    if k.startswith('eager/state.')}, device='cpu')
    want = cases.flat_step(tplan.step(cfg, prm, state, torch.from_numpy(runs.inputs['eager/action']),
                                      generator=torch.Generator().manual_seed(3)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jax_out = runs.jax['eager']
    common = set(got) & set(jax_out)
    assert {'state.pos', 'state.vel', 'obs.observation', 'reward', 'terminated'} <= common
    for k in sorted(common):
        if got[k].dtype.kind in 'biu':
            np.testing.assert_array_equal(got[k], jax_out[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], jax_out[k], rtol=1e-10, atol=1e-12, err_msg=k)


@pytest.mark.parametrize('k', [1, cases.K_LONG])
@pytest.mark.parametrize('name', ['pushing', 'planning_m1'])
def test_sharded_rollout_follows_the_rank_seed(runs, name, k):
    model = cases.STEP_CASES[name][0]
    cfg, prm = cases.make_env(name)
    half = cases.B // 2
    shard = cases.episode_state(name, cfg, prm, half, 7)
    t = cases.T_ROLL if k == 1 else cases.K_LONG
    acts = cases.rollout_actions(cases.B, t, 8)
    roll = model.make_fused_rollout(cfg, prm, steps_per_launch=k)
    key = f'roll_{name}_K{k}/'
    for r, out in enumerate(runs.r2):
        want = cases.flat_rollout(roll(shard, acts[:, r * half:(r + 1) * half], 11 + r * STRIDE))
        for kk, v in want.items():
            np.testing.assert_array_equal(out[key + kk], v, err_msg=f'rank {r} {kk}')
    a, b = runs.r2[0][key + 'state.pos'], runs.r2[1][key + 'state.pos']
    assert not np.array_equal(a, b), 'both ranks drew the same stream'


def test_sharded_reactive_rollout_splits_seed_and_generator(runs):
    from gymnasium_planar_robotics_tpu_torch.models import ppo
    from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush

    pcfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(16, 16), rollout_steps=2, action_scale=10.0)
    pol = ppo.init_params(pcfg, torch.Generator().manual_seed(0), device='cpu')
    cfg, prm = cases.make_env('pushing')
    shard = cases.episode_state('pushing', cfg, prm, cases.B // 2, 12)
    roll = tpush.make_reactive_rollout(cfg, prm, cases.policy_step_of(pcfg), 2)
    for r, out in enumerate(runs.r2):
        gen = sharding.rank_generator(torch.Generator().manual_seed(5), 2, r, 'cpu')
        want = cases.flat_reactive(roll(shard, pol, gen, 13 + r * STRIDE))
        for k, v in want.items():
            np.testing.assert_array_equal(out['reactive/' + k], v, err_msg=f'rank {r} {k}')
    assert not np.array_equal(runs.r2[0]['reactive/raw'], runs.r2[1]['reactive/raw'])


def test_metrics_summary_makes_one_all_reduce_and_matches_jax(runs):
    for ranks in (runs.r2, runs.r4):
        for r in ranks:
            assert int(r['summary/dist_calls']) == 1 and int(r['summary/all_reduce_calls']) == 1
            for name in cases.STEP_CASES:
                if f'{name}/dist_calls' in r:
                    assert int(r[f'{name}/dist_calls']) == 0, name
            for k, v in runs.jax['summary'].items():
                np.testing.assert_allclose(r[f'summary/{k}'], v, rtol=1e-6, atol=0, err_msg=k)
    assert runs.mesh_check.returncode == 0 and 'mesh ok' in runs.mesh_check.stdout, runs.mesh_check.stderr[-2000:]


def test_rollout_loop_over_ranks_reports_global_metrics(runs):
    a, b = runs.r2
    for k in ('reward_mean', 'done_rate', 'success_rate'):
        assert a[f'loop/{k}'].shape == (3,) and np.isfinite(a[f'loop/{k}']).all()
        np.testing.assert_array_equal(a[f'loop/{k}'], b[f'loop/{k}'])


@pytest.mark.parametrize('mode', ['fused', 'reactive'])
def test_sharded_ppo_keeps_parameters_equal_across_ranks(runs, mode):
    a, b = runs.r2
    np.testing.assert_array_equal(a[f'ppo_{mode}/params'], b[f'ppo_{mode}/params'])
    np.testing.assert_array_equal(a[f'ppo_{mode}/metrics'], b[f'ppo_{mode}/metrics'])
    params, metrics = runs.one_rank[mode]
    assert not np.array_equal(params, np.zeros_like(params))
    np.testing.assert_allclose(a[f'ppo_{mode}/params'], params, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a[f'ppo_{mode}/metrics'], metrics, rtol=1e-4, atol=1e-6)

