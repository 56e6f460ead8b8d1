"""Port parity: kernel G (K planning steps per launch), ``make_fused_rollout``,
``reset`` / ``init_batch`` and the slice as a whole.

- In injected mode the plain K-step rollout equals K plain autoreset steps
  bit for bit (the kernel's noise blocks are kernel F's, in order).
- ``make_fused_rollout`` at K=1 and at K=2 with a tail chunk equals the
  per-step public path on every env that never restarted, at
  ``std_noise=0`` (restart draws come from different streams by design),
  as the JAX package's ``test_fused_rollout_matches_per_step_path``.
- ``init_batch`` -> ``make_fused_step_autoreset`` -> ``make_fused_rollout``
  (K=2 with a tail) runs against the JAX package at ``std_noise=0`` on envs
  that never restart: positions to rtol 3e-5 / atol 3e-6 (ulp differences between the
  programs, over several steps), rewards and flags exactly.
- ``reset`` with start/goal overrides equals the JAX reset exactly; sampled
  starts and goals are wall-valid by the JAX package's ``qpos_is_valid``
  and cover the acceptance region uniformly.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.ops import walls as jwalls
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan

TOL_ROLL = dict(rtol=3e-5, atol=3e-6)
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
RING = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]])
LSHAPE = np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]])


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def far_goals(state):
    """Goals in the sampling box's corner farthest from each start."""
    return dataclasses.replace(state, goals=torch.where(state.pos < 0.36, 0.6, 0.12).to(state.pos.dtype))


def to_jax_state(tstate, seed=0):
    d = tplan.state_to_numpy(tstate)
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    return jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()}, key=keys)


@pytest.mark.parametrize('layout,coll,jerk', [(np.ones((3, 3)), {}, False), (LSHAPE, BOX, True)],
                         ids=['circle_full_acc', 'box_lshape_jerk'])
def test_plain_rollout_equals_k_autoreset_steps(layout, coll, jerk):
    cfg, prm = tplan.make_planning_env(layout, 1, collision_params=coll, learn_jerk=jerk, num_cycles=6,
                                       std_noise=[2e-3, 5e-2, 1e-5], device='cpu')
    kc = kplan.make_kernel_consts(cfg, prm, 2)
    b, K = 130, 3
    g = torch.Generator().manual_seed(0)
    state, _, _ = tplan.init_batch(cfg, prm, b, g)
    state.pos[: b // 4, 0, 0] = 0.6  # wall hits
    state.steps[::7] = cfg.max_episode_steps - 1  # truncation restarts
    st = tplan.state_to_planes(cfg, state)
    acts = (torch.rand((K, 2, b), generator=g) * 2 - 1) * (80.0 if jerk else 8.0)
    n = kplan.autoreset_noise_planes(cfg.num_cycles, 2, kc.box)
    u = torch.rand((K * n, b), generator=g)
    got_st, got_sig = kplan.planning_rollout(st, acts, kc, uniforms=u)
    for t in range(K):
        out = kplan.planning_autoreset_plain(st, acts[t], kc, u[t * n : (t + 1) * n])
        trunc = torch.where(st[8] + 1.0 >= cfg.max_episode_steps, 1.0, 0.0)
        assert torch.equal(got_sig[:, t], torch.stack([out[19], out[20], trunc])), t
        st = out[:9]
    assert torch.equal(got_st, st)
    assert got_sig[0].sum() > 0 and got_sig[2].sum() > 0


@pytest.mark.parametrize('steps_per_launch', [1, 2])
def test_fused_rollout_matches_per_step_path(steps_per_launch):
    """T=5: at K=2 two chunks of 2 (kernel G) and a tail of 1."""
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, std_noise=0.0, num_cycles=8, v_max=1.0, a_max=8.0,
                                       device='cpu')
    roll = tplan.make_fused_rollout(cfg, prm, cand_k=2, steps_per_launch=steps_per_launch)
    step = tplan.make_fused_step_autoreset(cfg, prm, cand_k=2)
    b, T = 128, 5
    g = torch.Generator().manual_seed(71)
    state = far_goals(tplan.init_batch(cfg, prm, b, g)[0])
    state.pos[:16, 0, 0] = 0.615  # wall hits in the first step
    acts = (torch.rand((T, b, 2), generator=g) - 0.5) * 2

    fs, rew, te, tr = roll(state, acts, 7)
    s2, done = state, torch.zeros(b, dtype=torch.bool)
    rews, dones = [], []
    for t in range(T):
        s2, _, r2, te2, tr2, _ = step(s2, acts[t], generator=g)
        rews.append(r2)
        dones.append(done.clone())
        done |= te2 | tr2
    live = ~done & ~(te | tr).any(0)
    assert 60 < int(live.sum()) < b
    for k in ('pos', 'vel', 'acc', 'act', 'goals', 'steps'):
        assert torch.equal(getattr(fs, k)[live], getattr(s2, k)[live]), k
    pre = ~torch.stack(dones)
    assert torch.equal(rew[pre], torch.stack(rews)[pre])
    assert rew.shape == te.shape == tr.shape == (T, b)


def test_slice_matches_jax():
    """init_batch (port) -> one autoreset step on the same injected uniforms
    -> a 3-step plane-form rollout at K=2 (a chunk of 2 on kernel G and a
    tail of 1), both packages, std_noise = 0.  (K=1 equals the per-step
    path, which equals the JAX package's: the tests above and
    ``test_torch_planning_autoreset.py``.)"""
    steps_per_launch = 2
    kw = dict(std_noise=0.0, num_cycles=8, v_max=1.0, a_max=8.0)
    jcfg, jprm = jplan.make_planning_env(np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]]), 1, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]]), 1, device='cpu', **kw)
    b, T = 128, 3
    g = torch.Generator().manual_seed(5)
    state = far_goals(tplan.init_batch(tcfg, tprm, b, g)[0])
    state.pos[:16, 0, 0] = 0.605
    rng = np.random.default_rng(6)
    act = rng.uniform(-8, 8, (b, 2)).astype(np.float32)
    jstep = jplan.make_fused_step_autoreset(jcfg, jprm, interpret=True, inject_noise=True, cand_k=2)
    tstep = tplan.make_fused_step_autoreset(tcfg, tprm, cand_k=2)
    u = rng.random((tstep.noise_planes, b), dtype=np.float32)
    js, _, jr, jt, jtr, _ = jstep(to_jax_state(state), jnp.asarray(act), noise=jnp.asarray(u))
    ts, _, tr, tt, ttr, _ = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), **TOL_ROLL)

    acts = rng.uniform(-1, 1, (T, b, 2)).astype(np.float32)
    jroll = jplan.make_fused_rollout(jcfg, jprm, interpret=True, cand_k=2, steps_per_launch=steps_per_launch)
    troll = tplan.make_fused_rollout(tcfg, tprm, cand_k=2, steps_per_launch=steps_per_launch)
    jf, jrew, jte, jtr2 = jroll(to_jax_state(ts), jnp.asarray(acts), 11)
    tf, trew, tte, ttr2 = troll(ts, torch.from_numpy(acts), 11)
    ended = (tte | ttr2).numpy() | np.asarray(jte | jtr2)
    live = ~(tt | ttr).numpy() & ~ended.any(0)
    assert b // 2 < int(live.sum()) < b
    for k in ('pos', 'vel', 'acc', 'goals'):
        np.testing.assert_allclose(getattr(tf, k).numpy()[live], np.asarray(getattr(jf, k))[live], **TOL_ROLL,
                                   err_msg=k)
    np.testing.assert_array_equal(tf.steps.numpy()[live], np.asarray(jf.steps)[live])
    # every step up to an env's first end agrees (restarted episodes differ)
    upto = (np.cumsum(ended, 0) - ended) == 0
    for got, want in ((trew, jrew), (tte, jte), (ttr2, jtr2)):
        np.testing.assert_array_equal(got.numpy()[upto], np.asarray(want)[upto])


@pytest.mark.parametrize('layout,coll', [(RING, {}), (LSHAPE, BOX)], ids=['circle_ring', 'box_lshape'])
def test_reset_overrides_match_jax(layout, coll):
    """Given starts and goals (some inside the hole: stalled, wall), at
    std_noise = 0: state, observation and info equal the JAX reset's."""
    kw = dict(collision_params=coll, std_noise=0.0, learn_jerk=True)
    jcfg, jprm = jplan.make_planning_env(layout, 1, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(layout, 1, device='cpu', **kw)
    b = 64
    rng = np.random.default_rng(8)
    starts = rng.uniform(0.05, 0.67, (b, 2)).astype(np.float32)
    goals = rng.uniform(0.05, 0.67, (b, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    js, jo, ji = jax.jit(jax.vmap(lambda k, s, gl: jplan.reset(jcfg, jprm, k, start_xy=s, goals_xy=gl)))(
        keys, jnp.asarray(starts), jnp.asarray(goals))
    ts, to, ti = tplan.reset(tcfg, tprm, b, torch.Generator().manual_seed(0), start_xy=torch.from_numpy(starts),
                             goals_xy=torch.from_numpy(goals))
    for k in ('pos', 'vel', 'acc', 'act', 'goals', 'steps'):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), err_msg=k)
    for k in ('observation', 'achieved_goal', 'desired_goal'):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=k)
    for k in ('is_success', 'mover_collision', 'wall_collision', 'reset_stalled', 'reset_trials'):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    assert 0 < int(ti['reset_stalled'].sum()) < b and 0 < int(ti['wall_collision'].sum()) < b


@pytest.mark.filterwarnings('ignore:Collision circle')
@pytest.mark.parametrize('coll', [{'shape': 'circle', 'size': 0.05}, BOX], ids=['circle', 'box'])
def test_sampled_resets_wall_valid_and_uniform(coll):
    """Starts and goals of init_batch on the ring layout: every one valid by
    the JAX package's dense rule at the sampling size, and spread over the
    acceptance region like uniform draws filtered by that rule."""
    jcfg, jprm = jplan.make_planning_env(RING, 1, collision_params=coll, dtype=jnp.float32)
    tcfg, tprm = tplan.make_planning_env(RING, 1, collision_params=coll, device='cpu')
    b = 4000
    state, _, info = tplan.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(13))
    assert not bool(info['reset_stalled'].any()) and int(info['reset_trials'].min()) >= 2
    c = (np.asarray(jprm.c_size) + np.asarray(jprm.c_offset) + np.asarray(jprm.c_offset_wall)).reshape(1, -1)

    @jax.jit
    def valid_jit(pts):
        n = len(pts)
        kw = {}
        if coll['shape'] == 'box':
            kw = dict(quat=jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, 0.0]], jnp.float32), (n, 1)), collision_shape='box')
            size = jnp.broadcast_to(jnp.asarray(c, jnp.float32), (n, 2))
        else:
            size = jnp.full((n,), float(c[0, 0]), jnp.float32)
        return jwalls.qpos_is_valid(jprm.grid, pts, size, **kw)

    def valid(pts):
        return np.asarray(valid_jit(jnp.asarray(pts)))

    rng = np.random.default_rng(0)
    lo, hi = np.asarray(jprm.min_xy), np.asarray(jprm.max_xy)
    cand = rng.uniform(lo, hi, (20000, 2)).astype(np.float32)
    oracle = cand[valid(cand)]
    centre = (lo + hi) / 2

    def quadrants(pts):
        below = pts < centre
        return np.array([(below[:, 0] & below[:, 1]).mean(), (below[:, 0] & ~below[:, 1]).mean(),
                         (~below[:, 0] & below[:, 1]).mean(), (~below[:, 0] & ~below[:, 1]).mean()])

    for pts in (state.pos.numpy()[:, 0], state.goals.numpy()[:, 0]):
        assert valid(pts).all(), 'a reset sampled a wall-invalid position'
        assert (pts >= lo).all() and (pts <= hi).all()
        assert (np.abs(quadrants(pts) - quadrants(oracle)) < 0.04).all()
        # first and second moments of the accepted draws
        assert (np.abs(pts.mean(0) - oracle.mean(0)) < 0.01).all()
        assert (np.abs(pts.std(0) - oracle.std(0)) < 0.01).all()
