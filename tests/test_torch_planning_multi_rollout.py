"""Port parity: the M-mover ``make_fused_rollout`` and ``multi_agent``.

- ``make_fused_rollout`` with M movers (one kernel H step per time step)
  equals the port's per-step path on every env that never restarted, at
  ``std_noise=0`` (restart draws come from different streams by design), and
  matches the JAX package's ``_make_fused_rollout_multi`` (Pallas in
  interpret mode) there: state to rtol 3e-5 / atol 3e-6, rewards and flags
  exactly up to each env's first episode end.
- ``multi_agent.split_obs`` and ``per_agent_rewards`` equal the JAX
  package's on the same observation dicts; ``make_batched_parallel_step``
  with injected uniforms equals what the JAX package composes on a TPU:
  its fused autoreset step (interpret mode, same uniforms), then
  ``split_obs`` and ``per_agent_rewards`` on the final observation.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import multi_agent as jma
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.models import multi_agent as tma
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan

TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ROLL = dict(rtol=3e-5, atol=3e-6)
KW = dict(std_noise=0.0, num_cycles=5, v_max=1.0, a_max=8.0)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def to_jax_state(tstate, seed=0):
    d = tplan.state_to_numpy(tstate)
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    return jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()}, key=keys)


def slow_state(cfg, prm, b, seed):
    """init_batch with every goal at the far side of the table from its
    mover (no goal is reached in a few slow steps); an eighth of the envs
    with mover 0 at the -x wall (episode ends in the first step)."""
    state = tplan.init_batch(cfg, prm, b, torch.Generator().manual_seed(seed))[0]
    lo, hi = prm.min_xy, prm.max_xy
    goals = torch.where(state.pos < (lo + hi) / 2, hi, lo).to(state.pos.dtype)
    pos = state.pos.clone()
    pos[: b // 8, 0, 0] = 0.105
    return dataclasses.replace(state, pos=pos, goals=goals)


def test_multi_rollout_matches_per_step_path():
    """M = 3, T = 5; ``steps_per_launch`` is ignored for M movers."""
    cfg, prm = tplan.make_planning_env(np.ones((4, 4)), 3, device='cpu', **KW)
    roll = tplan.make_fused_rollout(cfg, prm, cand_k=2, steps_per_launch=4)
    step = tplan.make_fused_step_autoreset(cfg, prm, cand_k=2)
    b, T = 130, 5
    state = slow_state(cfg, prm, b, 71)
    acts = (torch.rand((T, b, 3, 2), generator=torch.Generator().manual_seed(72)) - 0.5) * 2
    fs, rew, te, tr = roll(state, acts, 7)
    s2, done = state, torch.zeros(b, dtype=torch.bool)
    rews, dones = [], []
    for t in range(T):
        s2, _, r2, te2, tr2, _ = step(s2, acts[t], generator=torch.Generator().manual_seed(t))
        rews.append(r2)
        dones.append(done.clone())
        done |= te2 | tr2
    live = ~done & ~(te | tr).any(0)
    assert b // 2 < int(live.sum()) < b
    for k in ('pos', 'vel', 'acc', 'act', 'goals', 'steps'):
        assert torch.equal(getattr(fs, k)[live], getattr(s2, k)[live]), k
    pre = ~torch.stack(dones)
    assert torch.equal(rew[pre], torch.stack(rews)[pre])
    assert rew.shape == te.shape == tr.shape == (T, b) and fs.pos.shape == (b, 3, 2)


def test_multi_rollout_matches_jax():
    """M = 2, T = 3, both packages from the same state; the JAX rollout runs
    its kernel's hardware-PRNG mode, whose interpret-mode bits are zeros, so
    the two part only where an episode restarts."""
    jcfg, jprm = jplan.make_planning_env(np.ones((3, 3)), 2, dtype=jnp.float32, **KW)
    tcfg, tprm = tplan.make_planning_env(np.ones((3, 3)), 2, device='cpu', **KW)
    b, T = 130, 3
    state = slow_state(tcfg, tprm, b, 5)
    acts = np.random.default_rng(6).uniform(-1, 1, (T, b, 2, 2)).astype(np.float32)
    jf, jrew, jte, jtr = jplan.make_fused_rollout(jcfg, jprm, interpret=True, cand_k=2)(
        to_jax_state(state), jnp.asarray(acts), 11)
    tf, trew, tte, ttr = tplan.make_fused_rollout(tcfg, tprm, cand_k=2)(state, torch.from_numpy(acts), 11)
    ended = (tte | ttr).numpy() | np.asarray(jte | jtr)
    live = ~ended.any(0)
    assert b // 2 < int(live.sum()) < b
    for k in ('pos', 'vel', 'acc', 'goals'):
        np.testing.assert_allclose(getattr(tf, k).numpy()[live], np.asarray(getattr(jf, k))[live], **TOL_ROLL,
                                   err_msg=k)
    np.testing.assert_array_equal(tf.steps.numpy()[live], np.asarray(jf.steps)[live])
    upto = (np.cumsum(ended, 0) - ended) == 0  # every step up to an env's first end
    for got, want in ((trew, jrew), (tte, jte), (ttr, jtr)):
        np.testing.assert_array_equal(got.numpy()[upto], np.asarray(want)[upto])
    assert (trew.numpy() == -50.0).any()


@pytest.mark.parametrize('jerk', [False, True], ids=['acc', 'jerk'])
def test_split_obs_and_per_agent_rewards_match_jax(jerk):
    m, b = 3, 64
    kw = dict(learn_jerk=jerk)
    jcfg, jprm = jplan.make_planning_env(np.ones((4, 4)), m, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.ones((4, 4)), m, device='cpu', **kw)
    rng = np.random.default_rng(3)
    obs = {'observation': rng.normal(size=(b, (4 if jerk else 2) * m)).astype(np.float32),
           'achieved_goal': rng.uniform(0.2, 0.7, (b, 2 * m)).astype(np.float32),
           'desired_goal': rng.uniform(0.2, 0.7, (b, 2 * m)).astype(np.float32)}
    obs['achieved_goal'][: b // 2] = obs['desired_goal'][: b // 2] + 0.05  # within the threshold
    reward = rng.choice([50.0, -50.0, -1.0, -2.0, 0.0], b).astype(np.float32)
    want = jma.split_obs(jcfg, {k: jnp.asarray(v) for k, v in obs.items()})
    got = tma.split_obs(tcfg, {k: torch.from_numpy(v) for k, v in obs.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_r = jma.per_agent_rewards(jcfg, jprm, want[1], want[2], jnp.asarray(reward))
    got_r = tma.per_agent_rewards(tcfg, tprm, got[1], got[2], torch.from_numpy(reward))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert set(np.unique(got_r.numpy())) == {50.0, -50.0, 0.0, -1.0}


def test_batched_parallel_step_matches_jax_composition():
    """The bench configuration cut to 4 cycles: 4 movers on the 4x4 table,
    two steps with injected uniforms, per-agent views and rewards."""
    kw = dict(std_noise=[2e-3, 5e-2, 1e-5], num_cycles=4)
    jcfg, jprm = jplan.make_planning_env(np.ones((4, 4)), 4, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.ones((4, 4)), 4, device='cpu', **kw)
    b = 150
    state = tplan.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(12))[0]
    state.pos[: b // 4, 0, 0] = 0.105  # wall hits end episodes
    state.goals[b // 4 : b // 2] = state.pos[b // 4 : b // 2] + 0.02  # goals reached
    jfused = jax.jit(jplan.make_fused_step_autoreset(jcfg, jprm, interpret=True, inject_noise=True))
    tstep = tma.make_batched_parallel_step(tcfg, tprm)
    rng = np.random.default_rng(13)
    events = set()
    for t in range(2):
        act = rng.uniform(-8, 8, (b, 4, 2)).astype(np.float32)
        u = rng.random((tstep.noise_planes, b), dtype=np.float32)
        js, jobs, jr, jt, jtr, ji = jfused(to_jax_state(state, t), jnp.asarray(act.reshape(b, 8)),
                                          noise=jnp.asarray(u))
        jo, ja, jd = jma.split_obs(jcfg, jobs)
        _, jfa, jfd = jma.split_obs(jcfg, ji['final_observation'])
        jrew = jma.per_agent_rewards(jcfg, jprm, jfa, jfd, jr)
        ts, out = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u))
        np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), **TOL)
        for got, want in ((out.observation, jo), (out.achieved_goal, ja), (out.desired_goal, jd)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(out.reward.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(out.terminated.numpy(), np.repeat(np.asarray(jt)[:, None], 4, 1))
        np.testing.assert_array_equal(out.truncated.numpy(), np.repeat(np.asarray(jtr)[:, None], 4, 1))
        assert out.observation.shape == (b, 4, 2) and out.reward.shape == (b, 4)
        events |= set(np.unique(out.reward.numpy()).tolist())
        state = ts
    assert {50.0, -50.0, -1.0} <= events
