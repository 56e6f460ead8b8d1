"""Port parity: PPO's ``make_train_step`` over the eager pushing step and
the ``train_push_strong`` recipe's strict eval, against the JAX package's.

The train step: one iteration of the recipe's dense shaping (8 cycles, a
narrow policy, 3 rollout steps, 2 epochs) from states that end no episode
inside the rollout, the JAX step run as it is under ``jax.jit``, the port
given the same weights (``ppo.params_from_numpy``), the JAX step's own
exploration noise (its key split as in ``ppo.py:283-284``) and its env
noise (each env's key chain, ``pushing.py:395-402``).  Tolerances: metrics
rtol 1e-4; env state rtol 3e-5 / atol 3e-6; weights rtol 1e-5 / atol 2e-7,
as in ``test_torch_ppo.py``: Adam moves a weight by about +-lr where its
gradient dwarfs eps, so gradients that differ in rounding move weights by
a few ulps.

The eval: both packages from the JAX package's ``init_batch`` episodes,
``std_noise = 0``, a fixed policy that steers the mover toward the goal
from noise-free features (the object's 1e-5 observation noise differs
between the packages: the final distances agree to 1e-4, the success and
wall rates exactly).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import tools.train_push_strong as jtps
from gymnasium_planar_robotics_tpu.models import ppo as jppo
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.models import ppo as tppo
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.tools import train_push_strong as ttps
from test_torch_pushing_step import jax_noise, to_jax

CFG = jppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(32, 24), rollout_steps=3, update_epochs=2,
                     action_scale=10.0)
TCFG = tppo.PPOConfig(**dataclasses.asdict(CFG))


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_recipe_constants_and_features_match_jax():
    assert ttps.PUSHING_KW == jtps.PUSHING_KW and ttps.HORIZON == jtps.HORIZON
    assert sorted(ttps.RECIPES) == sorted(jtps.RECIPES)
    rng = np.random.default_rng(0)
    obs = {k: rng.normal(size=(7, n)).astype(np.float32) for k, n in (('observation', 4), ('achieved_goal', 2),
                                                                      ('desired_goal', 2))}
    got = ttps.obs_to_vec({k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtps.obs_to_vec({k: jnp.asarray(v) for k, v in obs.items()})))


def test_make_train_step_over_the_eager_step_matches_jax():
    kw = dict(jtps.PUSHING_KW, num_cycles=8)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, reward_mode='dense', **kw)
    tcfg, tprm = tpush.make_pushing_env(device='cpu', reward_mode='dense', **kw)
    b = 64
    g = torch.Generator().manual_seed(1)
    state, _, _ = tpush.init_batch(tcfg, tprm, b, g)
    # away from the walls, objects in reach of some movers: no episode ends
    state.pos = torch.clamp(state.pos, 0.25, 0.47)
    plant = (torch.arange(b) < 24) & (state.obj_pos[:, 0] > 0.26)
    state.pos[plant] = state.obj_pos[plant] + torch.tensor([-0.115, 0.0])
    jstate = to_jax(state, 2)
    obs_vec = np.concatenate([np.asarray(x) for x in (state.pos, state.vel, state.obj_pos, state.goal,
                                                      state.obj_pos - state.pos, state.goal - state.obj_pos)], -1)
    jpol = jppo.init_params(jax.random.PRNGKey(3), CFG)
    jpol['mu']['w'] = jpol['mu']['w'] * 50.0  # actions that push
    tpol = tppo.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpol), device='cpu')

    jtrain, jopt = jppo.make_train_step(jcfg, jprm, CFG, jpush.step_autoreset, obs_to_vec=jtps.obs_to_vec)
    key = jax.random.PRNGKey(4)
    (jstate2, jobs2, jpol2, _, _), jm = jax.jit(jtrain)((jstate, jnp.asarray(obs_vec), jpol, jopt.init(jpol), key))

    # the JAX step's draws: exploration noise from the runner key's splits,
    # env noise from each env's key chain (no env restarts)
    eps, noises, keys = [], [], jstate.key
    for _ in range(CFG.rollout_steps):
        key, k_act = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(k_act, (b, CFG.action_dim), jnp.float32)))
        noises.append(jax_noise(keys, tcfg.num_cycles, 'float32'))
        keys = jax.vmap(lambda k: jax.random.split(jax.random.split(k, 3)[0])[1])(keys)
    noise_iter = iter(noises)

    def step_fn(config, params, s, a, generator=None):
        return tpush.step_autoreset(config, params, s, a, noise=next(noise_iter), generator=generator)

    ttrain, make_opt = tppo.make_train_step(tcfg, tprm, TCFG, step_fn, obs_to_vec=ttps.obs_to_vec)
    (tstate2, tobs2, tpol2, _, _), tm = ttrain((state, torch.from_numpy(obs_vec), tpol, make_opt(tpol), g),
                                              eps=torch.from_numpy(np.stack(eps)))

    assert float(tm['done_rate']) == float(jm['done_rate']) == 0.0
    for k in ('loss', 'reward_mean'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    for f in ('pos', 'vel', 'obj_pos', 'obj_vel', 'obj_yaw', 'mover_z'):
        np.testing.assert_allclose(getattr(tstate2, f).numpy(), np.asarray(getattr(jstate2, f)), rtol=3e-5,
                                   atol=3e-6, err_msg=f)
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=3e-5, atol=3e-6)
    assert (np.abs(tstate2.obj_pos.numpy() - state.obj_pos.numpy()) > 1e-5).any(), 'no contact'
    for got, want, old in zip(leaves(tppo.params_to_numpy(tpol2)), leaves(jpol2), leaves(jpol)):
        assert np.abs(want - old).max() > 0.5 * CFG.learning_rate  # every leaf moved
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-7)


def test_strict_eval_matches_jax_from_the_same_episodes():
    kw = dict(jtps.PUSHING_KW, std_noise=0.0)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(device='cpu', **kw)
    episodes, seed = 96, 100
    jstate, jobs, _ = jpush.init_batch(jcfg, jprm, jax.random.PRNGKey(seed), episodes)
    state = tpush.state_from_numpy({f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)},
                                   device='cpu')
    obs = {k: torch.from_numpy(np.asarray(v)) for k, v in jobs.items()}

    # steer the mover toward the goal, damped: features 0-3 mover position
    # and velocity, 6-7 the goal (all noise-free at std_noise = 0)
    def jpolicy(_, vec):
        return jnp.clip(8.0 * (vec[:, 6:8] - vec[:, 0:2]) - 3.0 * vec[:, 2:4], -10.0, 10.0)

    def tpolicy(_, vec):
        return torch.clamp(8.0 * (vec[:, 6:8] - vec[:, 0:2]) - 3.0 * vec[:, 2:4], -10.0, 10.0)

    want = jtps.make_eval(jcfg, jprm, episodes=episodes, seed=seed)(None, jpolicy)
    got = ttps.make_eval(tcfg, tprm, episodes=episodes)(None, tpolicy, initial=(state, obs,
                                                                               torch.Generator().manual_seed(0)))
    for k in ('success', 'success_any', 'wall_rate'):
        assert got[k] == want[k], (k, got, want)
    for k in ('dfin_med', 'dfin_p90'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert 0 < want['success_any'] and want['dfin_med'] > 0


def test_train_runs_one_iteration_on_the_cpu():
    """``train`` end to end, one iteration on 32 envs, its strict eval of
    1024 episodes; the policy learns something and the log names the eval."""
    lines, timings = [], {}
    before = tppo.init_params(tppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(128, 128)),
                              torch.Generator().manual_seed(0), device='cpu')
    pol = ttps.train('baseline', 1, 32, 0, 5, log=lines.append, device='cpu', timings=timings)
    assert any(not torch.equal(a, p) for a, p in zip(before.parameters(), pol.parameters()))
    assert lines[0].startswith('iter      1') and 'succ' in lines[0] and lines[-1].startswith('best: iter 1')
    assert len(timings['iter_ms']) == 1 and len(timings['evals']) == 1
    assert 0.0 <= timings['evals'][0]['wall_rate'] <= 1.0
