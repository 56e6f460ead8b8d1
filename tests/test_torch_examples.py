"""The port's example scripts (``gymnasium_planar_robotics_tpu_torch/
examples/``) run end to end with tiny arguments on the CPU, as
``tests/test_examples_smoke.py`` runs the JAX package's, and print the same
key words; ``train_sharded`` on 2 gloo ranks (parameters equal on both) and
alone with ``--reactive``; ``custom_env`` held against the JAX package's
``examples/custom_env.py`` step by step at ``std_noise=0`` (float32, rtol
1e-5 / atol 1e-6, flags and rewards exact), as
``tests/test_custom_env_example.py`` exercises it."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu_torch.examples import collect_trajectories, custom_env, train_her, train_ppo
from gymnasium_planar_robotics_tpu_torch.utils import trajstore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_sharding_worker.py')


def _jax_custom_env():
    spec = importlib.util.spec_from_file_location('jax_custom_env_example',
                                                  os.path.join(ROOT, 'examples', 'custom_env.py'))
    mod = importlib.util.module_from_spec(spec)
    sys.modules['jax_custom_env_example'] = mod  # dataclasses resolve annotations through sys.modules
    spec.loader.exec_module(mod)
    return mod


def test_train_ppo_example(capsys):
    train_ppo.main(['--batch', '32', '--iters', '1', '--device', 'cpu'])
    assert 'iter' in capsys.readouterr().out


def test_train_her_example(capsys):
    train_her.main(['--batch', '64', '--iters', '3', '--device', 'cpu'])
    assert 'episode_success' in capsys.readouterr().out


def test_collect_trajectories_example(tmp_path, capsys):
    out = tmp_path / 'traj'
    collect_trajectories.main(['--out', str(out), '--batch', '64', '--steps', '4', '--device', 'cpu'])
    assert 'wrote 4 frames' in capsys.readouterr().out
    with trajstore.TrajReader(out) as r:
        leaves = r.get_arrays(3)
    # keys sorted as JAX flattens them: action, done, obs (3 leaves), reward
    assert [x.shape for x in leaves] == [(64, 2), (64,), (64, 2), (64, 2), (64, 2), (64,)]


def test_train_sharded_example_on_two_ranks_and_alone(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    ranks = [subprocess.Popen([sys.executable, WORKER, str(r), '2', str(tmp_path), 'example'], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    alone = subprocess.run([sys.executable, '-m', 'gymnasium_planar_robotics_tpu_torch.examples.train_sharded',
                            '--batch', '256', '--iters', '2', '--rollout', '2', '--cycles', '3', '--device', 'cpu',
                            '--reactive'], cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    logs = [p.communicate(timeout=240)[0] for p in ranks]
    assert all(p.returncode == 0 for p in ranks), logs
    assert alone.returncode == 0 and 'over 1 rank(s), reactive plane-form rollout' in alone.stdout, alone.stderr
    a, b = (np.load(tmp_path / f'example_rank{r}.npz') for r in range(2))
    assert 'over 2 rank(s), fused sharded rollout' in bytes(a['log']).decode()
    assert int(a['ranks']) == 2 and bytes(b['log']).strip() == b''  # rank 1 prints nothing
    np.testing.assert_array_equal(a['params'], b['params'])
    assert np.isfinite(a['params']).all()


def test_custom_env_matches_the_jax_example():
    jmod = _jax_custom_env()
    jcfg, jprm = jmod.make_reaching_env()
    cfg, prm = custom_env.make_reaching_env(device='cpu')
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for f in dataclasses.fields(prm):
        if f.name != 'grid':
            np.testing.assert_allclose(getattr(prm, f.name).numpy(), np.asarray(getattr(jprm, f.name)), err_msg=f.name)
    prm = dataclasses.replace(prm, std_noise=torch.zeros(3))
    jprm = dataclasses.replace(jprm, std_noise=jnp.zeros(3, jnp.float32))
    b = 32
    state, obs, _ = custom_env.reset(cfg, prm, b, torch.Generator().manual_seed(0))
    assert bool(custom_env._valid(prm, state.pos).all())
    state.pos[:4] = torch.tensor([0.115, 0.4])  # at the -x wall: the action below drives them in
    jstate = jmod.ReachingState(pos=jnp.asarray(state.pos.numpy()), vel=jnp.asarray(state.vel.numpy()),
                                goal=jnp.asarray(state.goal.numpy()), held=jnp.asarray(state.held.numpy()),
                                steps=jnp.asarray(state.steps.numpy()),
                                key=jax.random.split(jax.random.PRNGKey(0), b))
    jstep = jax.jit(jax.vmap(lambda s, a: jmod.step(jcfg, jprm, s, a)))
    ends = 0
    for t in range(12):
        actions = 10.0 * (state.goal - state.pos) - 2.0 * state.vel
        actions[:4] = torch.tensor([-10.0, 0.0])
        state, obs, rew, term, trunc, info = custom_env.step(cfg, prm, state, actions)
        jstate, jobs, jrew, jterm, jtrunc, jinfo = jstep(jstate, jnp.asarray(actions.numpy()))
        for k in ('pos', 'vel'):
            np.testing.assert_allclose(getattr(state, k).numpy(), np.asarray(getattr(jstate, k)), rtol=1e-5,
                                       atol=1e-6, err_msg=f'step {t} {k}')
        for got, want in ((state.held, jstate.held), (state.steps, jstate.steps), (rew, jrew), (term, jterm),
                          (trunc, jtrunc), (info['is_success'], jinfo['is_success']),
                          (info['wall_collision'], jinfo['wall_collision'])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f'step {t}')
        np.testing.assert_allclose(obs['achieved_goal'].numpy(), np.asarray(jobs['achieved_goal']), rtol=1e-5,
                                   atol=1e-6)
        ends += int(term.sum())
    assert ends > 0 and bool(info['wall_collision'][:4].all()) and int(state.held.max()) > 0


def test_custom_env_batched_autoreset(capsys):
    cfg, prm = custom_env.make_reaching_env(device='cpu')
    g = torch.Generator().manual_seed(0)
    state, obs, _ = custom_env.reset(cfg, prm, 32, g)
    seen = False
    for _ in range(12):
        actions = 10.0 * (obs['desired_goal'] - obs['achieved_goal']) - 2.0 * obs['observation']
        state, obs, rew, term, trunc, info = custom_env.batched_step_autoreset(cfg, prm, state, actions, g)
        seen = seen or bool(term.any())
        assert set(np.unique(rew.numpy())) <= {0.0, -1.0, -50.0}
    assert seen, 'the greedy controller never finished an episode'
    custom_env.main(['--batch', '64', '--device', 'cpu'])
    assert 'ReachingEnv: 50 batched autoreset steps OK' in capsys.readouterr().out
