"""Port parity: the eager pushing step (``step``, ``step_with_cycles``,
``step_autoreset``) against the JAX package's XLA path.

The port is handed JAX's own noise: each env's key is split as
``pushing._step_core`` and ``_get_obs`` split it (``pushing.py:395-402``,
``:562-569``) and the standard normals go to the port's ``noise=``.

Tolerances: float32 rtol 2e-6 / atol 2e-6 on positions, velocities,
object pose and mover z (the JAX package's own eager-vs-fused tolerance:
XLA contracts some multiply-adds, and contact amplifies an ulp),
accelerations rtol 1e-4 / atol 1e-5 (the clamp chain's ``(v' - v) / dt``
scales an ulp by 1000); float64 rtol 1e-9 / atol 1e-9 (contact carries
differences of an ulp forward: up to ~1e-10 over 50 steps), accelerations
atol 1e-8; flags and step counters equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush

LEAVES = ('pos', 'vel', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w', 'mover_z', 'mover_vz')


def tols(dtype):
    if dtype == 'float64':
        return dict(rtol=1e-9, atol=1e-9), dict(rtol=1e-9, atol=1e-8)
    return dict(rtol=2e-6, atol=2e-6), dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def envs(dtype, **kw):
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.dtype(dtype), **kw)
    tcfg, tprm = tpush.make_pushing_env(dtype=getattr(torch, dtype), device='cpu', **kw)
    return jcfg, jprm, tcfg, tprm


def planted(tcfg, tprm, b, seed):
    """init_batch; half the envs with the mover at the object's -x face
    moving into it (contact), a quarter near the -x wall moving out."""
    state, _, _ = tpush.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(seed))
    h, q = b // 2, b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], dtype=pos.dtype)
    vel[:h] = torch.tensor([0.4, 0.0], dtype=pos.dtype)
    pos[h:h + q, 0] = 0.115
    vel[h:h + q] = torch.tensor([-1.0, 0.2], dtype=pos.dtype)
    return dataclasses.replace(state, pos=pos, vel=vel)


def to_jax(tstate, seed):
    d = tpush.state_to_numpy(tstate)
    return jpush.PushingState(**{k: jnp.asarray(v) for k, v in d.items()},
                              key=jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0]))


def jax_noise(keys, num_cycles, dtype) -> dict:
    """The standard normals the JAX step draws from each env's key, in the
    port's layout (``tpush.draw_step_noise``, ``'obs'`` ``[6, B]``)."""
    dt = jnp.dtype(dtype)

    def one(k):
        _, k_cycles, k_obs = jax.random.split(k, 3)
        k_vel, k_wall = jax.random.split(k_cycles)
        k_pos, k_v, k_obj = jax.random.split(k_obs, 3)
        obs = jnp.concatenate([jax.random.normal(kk, (2,), dt) for kk in (k_pos, k_v, k_obj)])
        return jax.random.normal(k_vel, (num_cycles, 2), dt), jax.random.normal(k_wall, (num_cycles, 2), dt), obs

    v, p, o = (np.asarray(x) for x in jax.vmap(one)(keys))
    return {'vel': torch.from_numpy(v.transpose(1, 0, 2).copy()), 'pose': torch.from_numpy(p.transpose(1, 0, 2).copy()),
            'obs': torch.from_numpy(o.T.copy())}


def assert_states(got, want, dtype, rows=slice(None)):
    tol, tol_acc = tols(dtype)
    for k in LEAVES:
        np.testing.assert_allclose(getattr(got, k).numpy()[rows], np.asarray(getattr(want, k))[rows], **tol, err_msg=k)
    for k in ('acc', 'act'):
        np.testing.assert_allclose(getattr(got, k).numpy()[rows], np.asarray(getattr(want, k))[rows], **tol_acc,
                                   err_msg=k)
    for k in ('goal', 'steps'):
        np.testing.assert_array_equal(getattr(got, k).numpy()[rows], np.asarray(getattr(want, k))[rows], err_msg=k)


def assert_obs(got, want, dtype, rows=slice(None)):
    tol, tol_acc = tols(dtype)
    for k in ('observation', 'achieved_goal', 'desired_goal'):
        np.testing.assert_allclose(got[k].numpy()[rows], np.asarray(want[k])[rows], **tol_acc, err_msg=k)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('mode', ['acc', 'jerk_dense'])
def test_step_matches_jax_with_its_noise(mode, dtype):
    """One step at ``std_noise > 0`` from planted states: contact, wall
    hits inside the step (the latch), the dense reward in one mode."""
    jerk = mode.startswith('jerk')
    kw = dict(std_noise=[2e-4, 5e-3, 1e-5], learn_jerk=jerk, reward_mode='dense' if 'dense' in mode else 'sparse')
    jcfg, jprm, tcfg, tprm = envs(dtype, **kw)
    b = 96
    state = planted(tcfg, tprm, b, seed=1)
    jstate = to_jax(state, 2)
    limit = 80.0 if jerk else 8.0
    act = np.random.default_rng(3).uniform(-limit, limit, (b, 2)).astype(dtype)
    xs, xo, xr, xt, xtr, xi = jax.jit(lambda s, a: jpush.batched_step(jcfg, jprm, s, a))(jstate, jnp.asarray(act))
    ts, to, tr, tt, ttr, ti = tpush.batched_step(tcfg, tprm, state, torch.from_numpy(act),
                                                 noise=jax_noise(jstate.key, tcfg.num_cycles, dtype))
    assert_states(ts, xs, dtype)
    assert_obs(to, xo, dtype)
    np.testing.assert_allclose(tr.numpy(), np.asarray(xr), **tols(dtype)[0])
    for k in ('is_success', 'wall_collision', 'mover_collision'):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(xi[k]), err_msg=k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(xt))
    assert not ttr.any() and tr.dtype == getattr(torch, dtype)
    wall = ti['wall_collision'].numpy()
    assert 0 < wall.sum() < b and (np.abs(ts.obj_pos.numpy() - state.obj_pos.numpy()) > 1e-5).any()


def test_step_with_cycles_matches_jax():
    """The per-cycle (pos, vel, obj_pos, obj_yaw, done) stacks ``[B, C, ...]``."""
    jcfg, jprm, tcfg, tprm = envs('float32', std_noise=1e-4, num_cycles=12)
    b = 64
    state = planted(tcfg, tprm, b, seed=4)
    jstate = to_jax(state, 5)
    act = np.random.default_rng(6).uniform(-8.0, 8.0, (b, 2)).astype(np.float32)
    jout = jax.jit(jax.vmap(lambda s, a: jpush.step_with_cycles(jcfg, jprm, s, a)))(jstate, jnp.asarray(act))
    tout = tpush.step_with_cycles(tcfg, tprm, state, torch.from_numpy(act),
                                  noise=jax_noise(jstate.key, 12, 'float32'))
    assert_states(tout[0], jout[0], 'float32')
    for i, (got, want) in enumerate(zip(tout[6], jout[6])):
        assert got.shape == want.shape == ((b, 12, 2) if i < 3 else (b, 12))
        if i == 4:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tols('float32')[0])
    assert tout[6][4].any() and not tout[6][4].all()


def test_step_autoreset_matches_jax_over_55_steps():
    """``step_autoreset`` for 55 steps (float64, ``std_noise = 0``, random
    actions): every env that has not ended an episode matches JAX; an env
    ending one carries JAX's pre-reset observation in ``final_observation``
    and restarts in bounds (the restarts' draws differ, so from there on
    the env is not compared).  Wall hits end some episodes, the time limit
    at step 50 the rest."""
    jcfg, jprm, tcfg, tprm = envs('float64', std_noise=0.0)
    b = 48
    state = planted(tcfg, tprm, b, seed=7)
    jstate = to_jax(state, 8)
    jstep = jax.jit(lambda s, a: jpush.batched_step_autoreset(jcfg, jprm, s, a))
    g = torch.Generator().manual_seed(9)
    rng = np.random.default_rng(10)
    live = np.ones(b, bool)
    ends = {'terminated': 0, 'truncated': 0}
    for t in range(55):
        act = rng.uniform(-6.0, 6.0, (b, 2))
        noise = jax_noise(jstate.key, tcfg.num_cycles, 'float64')
        jstate, xo, xr, xt, xtr, xi = jstep(jstate, jnp.asarray(act))
        state, to, tr, tt, ttr, ti = tpush.step_autoreset(tcfg, tprm, state, torch.from_numpy(act), noise=noise,
                                                          generator=g)
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(xt)[live])
        np.testing.assert_array_equal(ttr.numpy()[live], np.asarray(xtr)[live])
        np.testing.assert_allclose(tr.numpy()[live], np.asarray(xr)[live], **tols('float64')[0])
        assert_obs(ti['final_observation'], xi['final_observation'], 'float64', live)
        done = (tt | ttr).numpy() & live
        ends['terminated'] += int((tt.numpy() & live).sum())
        ends['truncated'] += int((ttr.numpy() & live).sum())
        assert not ti['reset_stalled'].numpy()[done].any()
        live &= ~done
        assert_states(state, jstate, 'float64', live)
        assert_obs(to, xo, 'float64', live)
        # restarts in bounds, at rest, step 0
        if done.any():
            assert (state.steps.numpy()[done] == 0).all() and (state.vel.numpy()[done] == 0).all()
            for k, lo, hi in (('pos', tprm.min_xy, tprm.max_xy), ('obj_pos', tprm.obj_min_xy, tprm.obj_max_xy),
                              ('goal', tprm.obj_min_xy, tprm.obj_max_xy)):
                v = getattr(state, k).numpy()[done]
                assert ((v >= lo.numpy()) & (v <= hi.numpy())).all(), k
    assert ends['terminated'] > 0 and ends['truncated'] > 0 and not live.any(), ends
