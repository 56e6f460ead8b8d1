"""Port parity for the slice as a whole: ``make_pushing_env`` ->
``init_batch`` -> ``make_fused_rollout`` (kernel C per step, or kernel D
over chunks of K steps).

At ``std_noise = 0`` the port's rollout (plain versions on CPU) is held
against the JAX package's ``make_fused_rollout`` (interpret mode) on every
env that never restarted; restarted envs draw from different generators in
the two packages.  ``init_batch`` cannot match values (different
generators), so its invariants and statistics are checked instead.  Kernel
D and the whole path on the card are checked in ``test_torch_kernels_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush

# the JAX package's rollout-vs-step contract (FMA/ulp level on contact)
TOL = dict(rtol=3e-5, atol=3e-6)
CAND_K = 2


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def to_jax_state(tstate, seed=0):
    d = tpush.state_to_numpy(tstate)
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    return jpush.PushingState(**{k: jnp.asarray(v) for k, v in d.items()}, key=keys)


def planted(cfg, prm, b, seed, device='cpu'):
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    off = torch.tensor([-0.115, 0.0], device=device)
    return dataclasses.replace(state, pos=state.obj_pos + off,
                               vel=torch.tensor([0.3, 0.0], device=device).expand(b, 2).clone())


@pytest.mark.parametrize('steps_per_launch', [1, 2])
def test_rollout_matches_jax_on_envs_that_never_restart(steps_per_launch):
    kw = dict(std_noise=0.0, num_cycles=10)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    b, T = 128, 3
    state = planted(tcfg, tprm, b, seed=8)
    state.steps[::16] = tcfg.max_episode_steps - 2  # truncation restarts in step 2
    acts = np.tile(np.asarray([1.5, 0.2], np.float32), (T, b, 1))
    acts[:, 1::4] = [-6.0, 0.0]  # some movers reverse into their wall

    jroll = jpush.make_fused_rollout(jcfg, jprm, interpret=True, cand_k=CAND_K, steps_per_launch=steps_per_launch)
    js, jr, jte, jtr = jroll(to_jax_state(state), jnp.asarray(acts), 7)
    troll = tpush.make_fused_rollout(tcfg, tprm, cand_k=CAND_K, steps_per_launch=steps_per_launch)
    ts, tr, tte, ttr = troll(state, torch.from_numpy(acts), 7)

    assert tr.shape == (T, b) and tte.dtype == torch.bool and ts.steps.dtype == torch.int32
    jr, jte, jtr = np.asarray(jr), np.asarray(jte), np.asarray(jtr)
    # step 0 starts from identical states in every env; truncation is
    # counter-only until the first restart (interpret mode's PRNG gives the
    # JAX kernel all-zero bits, so its restarts stall and re-truncate)
    np.testing.assert_array_equal(tte[0].numpy(), jte[0])
    np.testing.assert_array_equal(ttr[0].numpy(), jtr[0])
    kept = ~(jte[0] | tte[0].numpy())
    np.testing.assert_array_equal(ttr[1].numpy()[kept], jtr[1][kept])
    np.testing.assert_array_equal(tr[0].numpy(), jr[0])
    live = ~(jte.any(0) | jtr.any(0) | tte.numpy().any(0) | ttr.numpy().any(0))
    assert 64 < live.sum() < b, f'live envs: {live.sum()}'
    for k in ('pos', 'vel', 'obj_pos', 'obj_vel', 'mover_z', 'obj_yaw'):
        np.testing.assert_allclose(getattr(ts, k).numpy()[live], np.asarray(getattr(js, k))[live], **TOL, err_msg=k)
    np.testing.assert_array_equal(ts.steps.numpy()[live], np.asarray(js.steps)[live])
    np.testing.assert_array_equal(tr.numpy()[:, live], jr[:, live])
    assert (np.abs(ts.obj_pos.numpy() - state.obj_pos.numpy())[live] > 1e-5).any(), 'contact never fired'
    assert set(np.unique(tr.numpy())) <= {0.0, -1.0, -50.0}
    assert tte.any() and ttr.any()


def test_rollout_chunks_match_per_step_launches():
    """K=2 over T=5 (two chunks + a tail) agrees with K=1 on envs that
    never restarted (std_noise=0: only restarts consume the streams)."""
    cfg, prm = tpush.make_pushing_env(std_noise=0.0, num_cycles=10, device='cpu')
    b, T = 96, 5
    state = planted(cfg, prm, b, seed=9)
    acts = torch.tensor([1.0, -0.3]).expand(T, b, 2)
    s1, r1, te1, tr1 = tpush.make_fused_rollout(cfg, prm, cand_k=CAND_K)(state, acts, 3)
    s2, r2, te2, tr2 = tpush.make_fused_rollout(cfg, prm, cand_k=CAND_K, steps_per_launch=2)(state, acts, 3)
    live = ~(te1.any(0) | tr1.any(0) | te2.any(0) | tr2.any(0))
    assert live.sum() > b // 2
    for k in ('pos', 'vel', 'obj_pos', 'obj_vel', 'mover_z', 'mover_vz', 'goal'):
        torch.testing.assert_close(getattr(s2, k)[live], getattr(s1, k)[live], rtol=0, atol=0)
    torch.testing.assert_close(r2[:, live], r1[:, live], rtol=0, atol=0)


def test_init_batch_invariants_and_statistics():
    cfg, prm = tpush.make_pushing_env(device='cpu')
    b = 4096
    state, obs, info = tpush.init_batch(cfg, prm, b, torch.Generator().manual_seed(0))
    lo, hi = prm.min_xy, prm.max_xy
    olo, ohi = prm.obj_min_xy, prm.obj_max_xy
    assert ((state.pos >= lo) & (state.pos <= hi)).all()
    assert ((state.obj_pos >= olo) & (state.obj_pos <= ohi)).all()
    assert ((state.goal >= olo) & (state.goal <= ohi)).all()
    stalled, trials = info['reset_stalled'], info['reset_trials']
    d = torch.linalg.vector_norm(state.obj_pos - state.pos, dim=-1)
    assert (d[~stalled] > prm.min_mo_dist).all()
    assert (trials >= 1).all() and (trials <= cfg.max_reset_trials).all()
    assert (trials[stalled] == cfg.max_reset_trials).all()
    assert (state.steps == 0).all() and state.steps.dtype == torch.int32
    assert (state.mover_z == prm.initial_zpos).all() and (state.vel == 0).all() and (state.obj_yaw == 0).all()
    assert obs['observation'].shape == (b, 4) and obs['achieved_goal'].shape == (b, 2)
    assert (obs['observation'][:, :2] - state.pos).abs().max() < 1e-4  # std 1e-5 observation noise
    assert set(info) >= {'is_success', 'mover_collision', 'wall_collision', 'reset_stalled', 'reset_trials'}
    assert not info['wall_collision'].any()  # starts lie inside the collision margin

    # acceptance statistics agree with the JAX package's reset
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32)
    _, _, jinfo = jpush.init_batch(jcfg, jprm, jax.random.PRNGKey(0), b)
    for got, want, tol in (
        (stalled.double().mean(), np.asarray(jinfo['reset_stalled']).mean(), 0.02),
        (trials.double().mean(), np.asarray(jinfo['reset_trials']).mean(), 1.5),
    ):
        assert abs(float(got) - float(want)) < tol, (float(got), float(want))


def test_reset_options_pin_mover_and_goal():
    cfg, prm = tpush.make_pushing_env(num_cycles=4, device='cpu')
    state, obs, info = tpush.reset(cfg, prm, 8, torch.Generator().manual_seed(1),
                                   mover_start_xy_pos=[0.2, 0.25], object_goal_xy_pos=[0.4, 0.35])
    assert (state.pos == torch.tensor([0.2, 0.25])).all()
    assert (state.goal == torch.tensor([0.4, 0.35])).all() and (obs['desired_goal'] == state.goal).all()
