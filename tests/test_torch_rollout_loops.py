"""Port parity: ``parallel/rollout.py``'s loops against the JAX package's
on the eager planning step at ``std_noise=0`` (float64, 1 mover, 10
cycles, goals planted far from the starts so that no episode ends and no
restart draws): the per-step metrics ``[T]`` within rtol 1e-10 and the final
state within atol 1e-12, for ``make_rollout_fn`` and
``make_rollout_fn_batched``; and the loops' shapes over the fused step."""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.parallel import rollout as jroll
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.parallel import rollout as troll

B, T = 16, 5
KW = dict(std_noise=0.0, num_cycles=10)


def _start():
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, dtype=torch.float64, device='cpu', **KW)
    state = tplan.init_batch(cfg, prm, B, torch.Generator().manual_seed(0))[0]
    state.goals = torch.where(state.pos < 0.36, 0.6, 0.12).to(torch.float64)
    return cfg, prm, state


def _obs(pos, vel, goals, lib):
    return {'observation': vel.reshape(B, 2), 'achieved_goal': pos.reshape(B, 2), 'desired_goal': goals.reshape(B, 2)}


def _policy(obs, _key):
    return 0.5 * (obs['desired_goal'] - obs['achieved_goal']) - 0.1 * obs['observation']


@pytest.mark.parametrize('batched', [False, True])
def test_rollout_loop_matches_jax(batched):
    cfg, prm, state = _start()
    jcfg, jprm = jplan.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float64, **KW)
    d = tplan.state_to_numpy(state)
    jstate = jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()},
                                 key=jax.random.split(jax.random.PRNGKey(0), B))
    jobs = _obs(jstate.pos, jstate.vel, jstate.goals, jnp)
    tobs = _obs(state.pos, state.vel, state.goals, torch)
    if batched:
        jstep = partial(jax.vmap(jplan.step_autoreset, in_axes=(None, None, 0, 0)), jcfg, jprm)
        jfn = jroll.make_rollout_fn_batched(jstep, _policy, T)
        tfn = troll.make_rollout_fn_batched(lambda s, a, generator=None: tplan.step_autoreset(
            cfg, prm, s, a, generator=generator), _policy, T)
    else:
        jfn = jroll.make_rollout_fn(jcfg, jprm, jplan.step_autoreset, _policy, T)
        tfn = troll.make_rollout_fn(cfg, prm, tplan.step_autoreset, _policy, T)
    js, jo, _, jm = jax.jit(jfn)(jstate, jobs, jax.random.PRNGKey(1))
    ts, to, g, tm = tfn(state, tobs, torch.Generator().manual_seed(1))
    assert set(tm) == set(jm) == {'reward_mean', 'done_rate', 'success_rate'}
    for k in tm:
        assert tm[k].shape == (T,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-10, atol=0, err_msg=k)
    assert float(tm['done_rate'].max()) == 0.0  # no restart: the comparison is draw-free
    for k in ('pos', 'vel', 'acc', 'steps'):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(to['achieved_goal'].numpy(), np.asarray(jo['achieved_goal']), atol=1e-12)


def test_uniform_policy_and_fused_loop_shapes():
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, num_cycles=3, device='cpu')
    g = torch.Generator().manual_seed(2)
    state, obs, _ = tplan.init_batch(cfg, prm, 64, g)
    policy = troll.uniform_policy(2, -10.0, 10.0)
    a = policy(obs, g)
    assert a.shape == (64, 2) and a.dtype == torch.float32 and (a.abs() <= 10.0).all() and a.std() > 1.0
    loop = troll.fused_rollout_loop(tplan, cfg, prm, policy, 4, cand_k=2)
    s, o, g2, metrics = loop(state, obs, g)
    assert g2 is g and all(v.shape == (4,) and torch.isfinite(v).all() for v in metrics.values())
    eager = troll.rollout_loop(cfg, prm, tplan.step_autoreset, policy, 2)
    s, o, _, metrics = eager(s, o, g)
    assert metrics['reward_mean'].shape == (2,) and (s.pos >= 0).all()
