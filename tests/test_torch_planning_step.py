"""Port parity: the eager planning step (``step``, ``step_with_cycles``,
``step_autoreset``; 1 and 3 movers, circle and box, acc and jerk, full and
holed layouts) against the JAX package's XLA path.

The port is handed JAX's own noise: each env's key is split as
``planning._step_core`` and ``_get_obs`` split it (``planning.py:419-429``,
``:504-524``) and the standard normals go to the port's ``noise=``.

Tolerances: float32 rtol 2e-6 / atol 2e-7 on positions and velocities (the
JAX package's eager-vs-fused tolerance, ``tests/test_pallas_step.py``),
accelerations rtol 1e-4 / atol 1e-5 (``(v' - v) / dt`` scales an ulp by
1000); float64 rtol 1e-9 / atol 1e-9 and 1e-8; wall and mover flags,
rewards, termination and step counters equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan

HOLED3 = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
HOLED4 = np.array([[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 1], [1, 1, 1, 1]])
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
# name -> (layout, movers, collision params, jerk)
CONFIGS = {
    'm1_circle_full_acc': (np.ones((3, 3)), 1, {}, False),
    'm1_box_holed_jerk': (HOLED3, 1, BOX, True),
    'm3_circle_holed_jerk': (HOLED4, 3, {'size': np.array([0.11, 0.14, 0.12])}, True),
    'm3_box_full_acc': (np.ones((4, 4)), 3, BOX, False),
}


def tols(dtype):
    if dtype == 'float64':
        return dict(rtol=1e-9, atol=1e-9), dict(rtol=1e-9, atol=1e-8)
    return dict(rtol=2e-6, atol=2e-7), dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def envs(name, dtype, **kw):
    layout, m, coll, jerk = CONFIGS[name]
    jcfg, jprm = jplan.make_planning_env(layout, m, collision_params=coll, learn_jerk=jerk, dtype=jnp.dtype(dtype),
                                         **kw)
    tcfg, tprm = tplan.make_planning_env(layout, m, collision_params=coll, learn_jerk=jerk,
                                         dtype=getattr(torch, dtype), device='cpu', **kw)
    return jcfg, jprm, tcfg, tprm


def driven(tcfg, tprm, b, seed):
    """init_batch; a quarter of the envs with mover 0 at the -x wall moving
    out, with M > 1 a quarter with movers 0 and 1 head-on 1 mm apart."""
    state, _, _ = tplan.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(seed))
    q = b // 4
    dt = state.pos.dtype
    hx = tprm.c_size.reshape(tcfg.num_movers, -1)[:, 0]
    state.pos[:q, 0, 0] = torch.linspace(float(hx[0]) - 0.01, float(hx[0]) + 0.02, q, dtype=dt)
    state.vel[:q, 0] = torch.tensor([-1.0, 0.1], dtype=dt)
    if tcfg.num_movers > 1:
        state.pos[q:2 * q, 1] = state.pos[q:2 * q, 0] + torch.stack([hx[0] + hx[1] + 1e-3, torch.zeros_like(hx[0])])
        state.vel[q:2 * q, 0] = torch.tensor([1.0, 0.0], dtype=dt)
        state.vel[q:2 * q, 1] = torch.tensor([-1.0, 0.0], dtype=dt)
    return state


def to_jax(tstate, seed):
    d = tplan.state_to_numpy(tstate)
    return jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()},
                               key=jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0]))


def jax_noise(keys, cfg, dtype) -> dict:
    """The standard normals the JAX step draws from each env's key, in the
    port's layout (``tplan.draw_step_noise``, ``'obs'`` ``[4M, B]``)."""
    c, m = cfg.num_cycles, cfg.num_movers
    n = 6 if cfg.collision_shape == 'box' else 2
    dt = jnp.dtype(dtype)

    def one(k):
        _, k_cycles, k_obs = jax.random.split(k, 3)
        k_vel, k_checks = jax.random.split(k_cycles)
        k_pos, k_v = jax.random.split(k_obs)
        obs = jnp.concatenate([jax.random.normal(k_pos, (m, 2), dt).reshape(-1),
                               jax.random.normal(k_v, (m, 2), dt).reshape(-1)])
        return jax.random.normal(k_vel, (c, m, 2), dt), jax.random.normal(k_checks, (c, 2, m, n), dt), obs

    v, p, o = (np.asarray(x) for x in jax.vmap(one)(keys))
    return {'vel': torch.from_numpy(np.moveaxis(v, 0, 1).copy()), 'pose': torch.from_numpy(np.moveaxis(p, 0, 1).copy()),
            'obs': torch.from_numpy(o.T.copy())}


def assert_states(got, want, dtype, rows=slice(None)):
    tol, tol_acc = tols(dtype)
    for k in ('pos', 'vel'):
        np.testing.assert_allclose(getattr(got, k).numpy()[rows], np.asarray(getattr(want, k))[rows], **tol, err_msg=k)
    for k in ('acc', 'act'):
        np.testing.assert_allclose(getattr(got, k).numpy()[rows], np.asarray(getattr(want, k))[rows], **tol_acc,
                                   err_msg=k)
    for k in ('goals', 'steps'):
        np.testing.assert_array_equal(getattr(got, k).numpy()[rows], np.asarray(getattr(want, k))[rows], err_msg=k)


def assert_obs(got, want, dtype, rows=slice(None)):
    for k in ('observation', 'achieved_goal', 'desired_goal'):
        np.testing.assert_allclose(got[k].numpy()[rows], np.asarray(want[k])[rows], **tols(dtype)[1], err_msg=k)


def assert_flags(ti, xi, rows=slice(None)):
    for k in ('is_success', 'wall_collision', 'mover_collision'):
        np.testing.assert_array_equal(ti[k].numpy()[rows], np.asarray(xi[k])[rows], err_msg=k)


@pytest.mark.parametrize('name,dtype', [(n, 'float32') for n in CONFIGS] + [('m3_circle_holed_jerk', 'float64')])
def test_step_matches_jax_with_its_noise(name, dtype):
    jcfg, jprm, tcfg, tprm = envs(name, dtype, std_noise=[2e-4, 5e-3, 1e-5])
    b, m = 96, tcfg.num_movers
    state = driven(tcfg, tprm, b, seed=1)
    jstate = to_jax(state, 2)
    limit = 80.0 if tcfg.learn_jerk else 8.0
    act = np.random.default_rng(3).uniform(-limit, limit, (b, m, 2)).astype(dtype)
    xs, xo, xr, xt, xtr, xi = jax.jit(lambda s, a: jplan.batched_step(jcfg, jprm, s, a))(jstate, jnp.asarray(act))
    ts, to, tr, tt, ttr, ti = tplan.batched_step(tcfg, tprm, state, torch.from_numpy(act),
                                                 noise=jax_noise(jstate.key, tcfg, dtype))
    assert_states(ts, xs, dtype)
    assert_obs(to, xo, dtype)
    assert_flags(ti, xi)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(xt))
    assert not ttr.any()
    assert 0 < int(ti['wall_collision'].sum()) < b
    if m > 1:
        assert 0 < int(ti['mover_collision'].sum()) < b


def test_step_with_cycles_matches_jax():
    """The per-cycle (pos, vel, done) stacks ``[B, C, ...]``, 3 movers."""
    jcfg, jprm, tcfg, tprm = envs('m3_box_full_acc', 'float32', std_noise=1e-4, num_cycles=10)
    b = 48
    state = driven(tcfg, tprm, b, seed=4)
    jstate = to_jax(state, 5)
    act = np.random.default_rng(6).uniform(-8.0, 8.0, (b, 3, 2)).astype(np.float32)
    jout = jax.jit(jax.vmap(lambda s, a: jplan.step_with_cycles(jcfg, jprm, s, a)))(jstate, jnp.asarray(act))
    tout = tplan.step_with_cycles(tcfg, tprm, state, torch.from_numpy(act), noise=jax_noise(jstate.key, tcfg,
                                                                                             'float32'))
    assert_states(tout[0], jout[0], 'float32')
    pos, vel, done = tout[6]
    assert pos.shape == (b, 10, 3, 2) and done.shape == (b, 10)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jout[6][0]), **tols('float32')[0])
    np.testing.assert_allclose(vel.numpy(), np.asarray(jout[6][1]), **tols('float32')[0])
    np.testing.assert_array_equal(done.numpy(), np.asarray(jout[6][2]))
    assert done.any() and not done.all()


@pytest.mark.parametrize('name', ['m1_circle_full_acc', 'm3_circle_holed_jerk'])
def test_step_autoreset_matches_jax_over_55_steps(name):
    """``step_autoreset`` for 55 steps (float64, ``std_noise = 0``): every env
    that has not ended an episode matches JAX; an env ending one carries
    JAX's pre-reset observation in ``final_observation`` and restarts in
    bounds (its restart's draws differ, so from there on it is not
    compared).  Collisions and reached goals end some episodes, the time
    limit at step 50 the rest."""
    jcfg, jprm, tcfg, tprm = envs(name, 'float64', std_noise=0.0)
    b, m = 48, tcfg.num_movers
    state = driven(tcfg, tprm, b, seed=7)
    jstate = to_jax(state, 8)
    jstep = jax.jit(lambda s, a: jplan.batched_step_autoreset(jcfg, jprm, s, a))
    g = torch.Generator().manual_seed(9)
    rng = np.random.default_rng(10)
    limit = 30.0 if tcfg.learn_jerk else 3.0
    live = np.ones(b, bool)
    ends = {'terminated': 0, 'truncated': 0}
    for t in range(55):
        act = rng.uniform(-limit, limit, (b, m, 2))
        act[b // 2:] = 0.0  # these envs stand still until the time limit
        noise = jax_noise(jstate.key, tcfg, 'float64')
        jstate, xo, xr, xt, xtr, xi = jstep(jstate, jnp.asarray(act))
        state, to, tr, tt, ttr, ti = tplan.step_autoreset(tcfg, tprm, state, torch.from_numpy(act), noise=noise,
                                                          generator=g)
        for got, want in ((tt, xt), (ttr, xtr), (tr, xr)):
            np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])
        assert_flags(ti, xi, live)
        assert_obs(ti['final_observation'], xi['final_observation'], 'float64', live)
        done = (tt | ttr).numpy() & live
        ends['terminated'] += int((tt.numpy() & live).sum())
        ends['truncated'] += int((ttr.numpy() & live).sum())
        assert not ti['reset_stalled'].numpy()[done].any()
        live &= ~done
        assert_states(state, jstate, 'float64', live)
        assert_obs(to, xo, 'float64', live)
        if done.any():
            assert (state.steps.numpy()[done] == 0).all() and (state.vel.numpy()[done] == 0).all()
            lo, hi = tprm.min_xy.numpy(), tprm.max_xy.numpy()
            for k in ('pos', 'goals'):
                v = getattr(state, k).numpy()[done]
                assert ((v >= lo) & (v <= hi)).all(), k
    assert ends['terminated'] > 0 and ends['truncated'] > 0 and not live.any(), ends
