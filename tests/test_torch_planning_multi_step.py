"""Port parity: the public M-mover planning step and reset.

- ``make_fused_step_autoreset`` with M movers (kernel H's plain version on
  CPU tensors) against the JAX package's (Pallas in interpret mode, the same
  injected uniforms) over three steps from the same planted states, sparse
  (per-mover radii, holed layout, one restart stalled by construction) and
  dense (per-mover box sizes), 200 envs (not a multiple of 128).
- ``reset`` acceptance against the JAX package's: candidate sets with pairs
  at the summed sizes +-1e-6 and goals at ``min_goal_dist`` +-1e-6 go
  through both packages' overrides at ``std_noise=0`` (circle, and box
  through the 16-segment test); ``init_batch``'s sampled sets are accepted
  by the JAX reset, trials count whole rounds of 8 sets, and a forced goal
  stall reports 104 goal trials as the JAX package does.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from torch_planning_multi_cases import CASES, actions, make_env, planted_state

TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
CAND_K = 2
KW = dict(std_noise=[2e-3, 5e-2, 1e-5], num_cycles=4)


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


@pytest.mark.parametrize('reward_mode', ['sparse', 'dense'])
def test_public_multi_step_matches_jax_over_three_steps(reward_mode):
    """Env 5 truncates in the first step and its restart stalls by
    construction (sparse case): every start and goal candidate lands in the
    missing tile."""
    name = 'circle_holed_jerk_m2' if reward_mode == 'sparse' else 'box_full_jerk_m2'
    layout, m, coll, jerk, _, _ = CASES[name]
    jcfg, jprm = jplan.make_planning_env(layout, m, dtype=jnp.float32, collision_params=coll, learn_jerk=jerk,
                                         reward_mode=reward_mode, **KW)
    tcfg, tprm = make_env(name, reward_mode=reward_mode, **KW)
    b, stall_env = 200, 5
    state = planted_state(name, tcfg, tprm, b, seed=4)
    state.steps[stall_env] = tcfg.max_episode_steps - 1
    jstep = jplan.make_fused_step_autoreset(jcfg, jprm, interpret=True, inject_noise=True, cand_k=CAND_K)
    tstep = tplan.make_fused_step_autoreset(tcfg, tprm, cand_k=CAND_K)
    assert tstep.noise_planes == jstep.noise_planes
    jstep = jax.jit(jstep)  # traced once for the three steps
    rng = np.random.default_rng(5)
    restarts = stalls = collisions = 0
    for t in range(3):
        act = actions(tcfg, b, seed=10 + t)
        u = rng.random((tstep.noise_planes, b), dtype=np.float32)
        if t == 0 and reward_mode == 'sparse':
            # start and goal samplers: x at 0.36, y at 0.6, in the missing tile (1, 2)
            base = kmulti.multi_noise_planes(tcfg.num_cycles, m, 0, False) - 4 * m
            u[base : base + 4 * m * CAND_K : 2, stall_env] = 0.5
            u[base + 1 : base + 4 * m * CAND_K : 2, stall_env] = 0.98
        js, jobs, jr, jt, jtr, ji = jstep(to_jax_state(state, t), jnp.asarray(act), noise=jnp.asarray(u))
        ts, tobs, tr, tt, ttr, ti = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u))

        for k in ('pos', 'vel', 'goals'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL, err_msg=k)
        for k in ('acc', 'act'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL_ACC, err_msg=k)
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
        for nm, got, want in (('obs', tobs, jobs), ('final_observation', ti['final_observation'],
                                                    ji['final_observation'])):
            for k in ('observation', 'achieved_goal', 'desired_goal'):
                tol = TOL_ACC if k == 'observation' and jerk else TOL
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **tol, err_msg=f'{nm}.{k}')
        if reward_mode == 'dense':
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
        else:
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        for k in ('is_success', 'wall_collision', 'mover_collision', 'reset_stalled', 'reset_trials'):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
        assert ts.pos.shape == (b, m, 2) and tr.shape == (b,) and ts.steps.dtype == torch.int32
        assert tobs['observation'].shape == (b, 4 * m if jerk else 2 * m)
        if t == 0 and reward_mode == 'sparse':
            assert bool(ti['reset_stalled'][stall_env]) and int(ti['reset_trials'][stall_env]) == 2 * CAND_K
            assert int(ts.steps[stall_env]) == tcfg.max_episode_steps  # not reset: retried next step
        done = (tt | ttr).numpy() & ~ti['reset_stalled'].numpy()
        restarts += int(done.sum())
        stalls += int(ti['reset_stalled'].sum())
        collisions += int(ti['mover_collision'].sum())
        assert (ts.steps.numpy()[done] == 0).all()
        state = ts
    assert restarts > 0 and collisions > 0
    if reward_mode == 'sparse':
        assert stalls >= 1
    else:
        assert (tr.numpy() < 0).any() and (tr.numpy() > -50).any()


def ring_offsets(rng, b, dist):
    """``b`` offsets of length ``dist`` [b] in random directions."""
    th = rng.uniform(-np.pi, np.pi, b)
    return dist[:, None] * np.stack([np.cos(th), np.sin(th)], -1)


@pytest.mark.parametrize('shape', ['circle', 'box'])
def test_reset_acceptance_matches_jax(shape):
    """std_noise = 0.  Starts: movers 0 and 1 at the summed sizes with the
    safety offset +-1e-6 (the start test), movers 1 and 2 (circle) at the
    summed sizes without it +-1e-6 (the noisy re-check's mover flag); goals:
    movers 0 and 1 at ``min_goal_dist`` +-1e-6.  Flags, state and
    observation equal the JAX reset's."""
    # sizes with the offsets stay within the tile's half-size (0.12): beyond
    # it the JAX package's dense XLA wall rule, which its reset uses, and its
    # kernels' rule, which the port's reset uses, part (ROADMAP.md section 3)
    off = 0.003
    if shape == 'circle':
        m, coll = 3, {'size': np.array([0.11, 0.115, 0.112]), 'offset': off, 'offset_wall': 0.002}
    else:
        m, coll = 2, {'shape': 'box', 'size': np.array([0.09, 0.08]), 'offset': off}
    kw = dict(collision_params=coll, std_noise=0.0)
    jcfg, jprm = jplan.make_planning_env(np.ones((4, 4)), m, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.ones((4, 4)), m, device='cpu', **kw)
    b = 256
    rng = np.random.default_rng(7)
    sign = np.where(np.arange(b) % 2 == 0, 1.0, -1.0)
    starts = np.zeros((b, m, 2))
    starts[:, 0] = rng.uniform(0.35, 0.45, (b, 2))
    if shape == 'circle':
        r = coll['size']
        starts[:, 1] = starts[:, 0] + ring_offsets(rng, b, r[0] + r[1] + 2 * off + sign * 1e-6)
        pair12 = r[1] + r[2] + rng.choice([1.0, -1.0], b) * 1e-6
        starts[:, 2] = starts[:, 1] + ring_offsets(rng, b, pair12)
        starts[b // 2:, 2] = [0.82, 0.82]  # half the sets keep mover 2 away
    else:
        # side by side along x (gap +-1e-6 at the inflated half-extents),
        # shifted along y by up to 3 cm
        starts[:, 1] = starts[:, 0] + np.stack([2 * (0.09 + off) + sign * 1e-6, rng.uniform(-0.03, 0.03, b)], -1)
    goals = np.zeros((b, m, 2))
    goals[:, 0] = rng.uniform(0.3, 0.6, (b, 2))
    gd = float(np.asarray(jprm.min_goal_dist))
    goals[:, 1] = goals[:, 0] + ring_offsets(rng, b, gd + np.where(np.arange(b) % 4 < 2, 1.0, -1.0) * 1e-6)
    if m > 2:
        goals[:, 2] = [0.82, 0.14]
    starts, goals = starts.astype(np.float32), goals.astype(np.float32)

    keys = jax.random.split(jax.random.PRNGKey(0), b)
    js, jo, ji = jax.jit(jax.vmap(lambda k, s, g: jplan.reset(jcfg, jprm, k, start_xy=s, goals_xy=g)))(
        keys, jnp.asarray(starts), jnp.asarray(goals))
    ts, to, ti = tplan.reset(tcfg, tprm, b, torch.Generator().manual_seed(0), start_xy=torch.from_numpy(starts),
                             goals_xy=torch.from_numpy(goals))
    for k in ('reset_stalled', 'mover_collision', 'wall_collision', 'is_success', 'reset_trials'):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    for k in ('pos', 'vel', 'acc', 'act', 'goals', 'steps'):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), err_msg=k)
    for k in ('observation', 'achieved_goal', 'desired_goal'):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=k)
    stalled = ti['reset_stalled'].numpy()
    assert 0.2 < stalled.mean() < 0.95  # both sides of each boundary were taken
    if shape == 'circle':
        mover = ti['mover_collision'].numpy()[: b // 2]
        assert 0 < mover.sum() < b // 2


def test_sampled_resets_accepted_by_jax_and_goal_stall():
    """init_batch at M = 3: every sampled start and goal set is accepted by
    the JAX reset, trials are whole rounds of 8; with an unreachable
    ``min_goal_dist`` both packages stall every goal sampler after 104 sets."""
    kw = dict(collision_params={'size': np.array([0.11, 0.12, 0.11])}, std_noise=0.0)
    jcfg, jprm = jplan.make_planning_env(np.ones((4, 4)), 3, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.ones((4, 4)), 3, device='cpu', **kw)
    b = 256
    state, _, info = tplan.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(8))
    trials = info['reset_trials'].numpy()
    assert not info['reset_stalled'].any() and (trials % 8 == 0).all() and (trials >= 16).all()
    assert (trials > 16).any()  # some samplers needed more than one round
    keys = jax.random.split(jax.random.PRNGKey(1), b)
    _, _, ji = jax.jit(jax.vmap(lambda k, s, g: jplan.reset(jcfg, jprm, k, start_xy=s, goals_xy=g)))(
        keys, jnp.asarray(state.pos.numpy()), jnp.asarray(state.goals.numpy()))
    assert not np.asarray(ji['reset_stalled']).any()

    far = 10.0
    jprm_f = dataclasses.replace(jprm, min_goal_dist=jnp.asarray(far, jnp.float32))
    tprm_f = dataclasses.replace(tprm, min_goal_dist=torch.tensor(far))
    _, _, tinfo = tplan.init_batch(tcfg, tprm_f, 64, torch.Generator().manual_seed(9))
    _, _, jinfo = jplan.init_batch(jcfg, jprm_f, jax.random.PRNGKey(2), 64)
    for info_ in (tinfo, jinfo):
        stalled, tr = np.asarray(info_['reset_stalled']), np.asarray(info_['reset_trials'])
        assert stalled.all() and ((tr - 104) % 8 == 0).all() and (tr - 104 >= 8).all()
