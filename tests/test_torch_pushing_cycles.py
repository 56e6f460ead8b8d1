"""Port parity: kernel B (pushing cycles) and ``make_fused_step``.

The plain version of kernel B is held against the JAX package's fused
Pallas step (interpret mode, injected uniforms) at ``std_noise > 0``, and
against the XLA scan path ``pushing.batched_step`` at ``std_noise = 0`` over
the full 40 cycles.  The CUDA kernel is held against the plain version on
the card in ``test_torch_kernels_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

# ulp-level: the programs contract multiply-adds differently; accelerations
# carry the clamp chain's (v' - v) / dt, which turns 1 ulp of |v| into 1e-4
TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
STATE_LEAVES = ('pos', 'vel', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w', 'mover_z', 'mover_vz')


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


def planted_state(cfg, prm, b, seed=0, device='cpu'):
    """init_batch, then: the first half of the envs planted at the object's
    -x face moving into it (contact), the next quarter near the -x wall
    moving out (a wall hit inside the step, then the latch)."""
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    h, q = b // 2, b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], device=device)
    vel[:h] = torch.tensor([0.4, 0.0], device=device)
    pos[h : h + q, 0] = 0.115
    vel[h : h + q] = torch.tensor([-1.0, 0.2], device=device)
    return dataclasses.replace(state, pos=pos, vel=vel)


def assert_states_close(got, want, keys=STATE_LEAVES):
    for k in keys:
        np.testing.assert_allclose(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)), **TOL, err_msg=k)
    for k in ('acc', 'act'):
        np.testing.assert_allclose(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)), **TOL_ACC, err_msg=k)


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_kernel_b_matches_pallas_injected(learn_jerk):
    """std_noise > 0, the same injected uniforms into both kernels."""
    kw = dict(std_noise=[2e-4, 5e-3, 1e-5], num_cycles=10, learn_jerk=learn_jerk)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    b = 128
    state = planted_state(tcfg, tprm, b)
    limit = 80.0 if learn_jerk else 8.0
    rng = np.random.default_rng(1)
    act = rng.uniform(-limit, limit, (b, 2)).astype(np.float32)
    tstep = tpush.make_fused_step(tcfg, tprm)
    u = rng.random((tstep.noise_planes, b), dtype=np.float32)

    jstep = jpush.make_fused_step(jcfg, jprm, interpret=True, inject_noise=True)
    assert jstep.noise_planes == tstep.noise_planes == kpush.cycles_noise_planes(10)
    js, jobs, jr, jt, jtr, ji = jstep(to_jax_state(state), jnp.asarray(act), noise=jnp.asarray(u))
    ts, tobs, tr, tt, ttr, ti = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u),
                                      generator=torch.Generator().manual_seed(2))

    assert_states_close(ts, js)
    np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
    np.testing.assert_array_equal(ts.goal.numpy(), np.asarray(js.goal))
    wall = ti['wall_collision'].numpy()
    np.testing.assert_array_equal(wall, np.asarray(ji['wall_collision']))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert not ttr.any() and not np.asarray(jtr).any()
    # rewards agree wherever the (differently noised) achieved goal is not
    # within the observation noise of the success threshold
    d = np.linalg.norm(ts.obj_pos.numpy() - ts.goal.numpy(), axis=-1)
    clear = np.abs(d - float(tprm.threshold_pos)) > 1e-3
    np.testing.assert_array_equal(tr.numpy()[clear], np.asarray(jr)[clear])
    assert tobs['observation'].shape == np.asarray(jobs['observation']).shape
    # both regimes fired: contact moved objects, walls latched
    assert (np.abs(ts.obj_pos.numpy() - state.obj_pos.numpy()) > 1e-5).any()
    assert 0 < wall.sum() < b


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_kernel_b_matches_xla_step_at_zero_noise(learn_jerk):
    """std_noise = 0, all 40 cycles, against the XLA scan path (the
    tolerances of the JAX package's own fused-vs-XLA test)."""
    kw = dict(std_noise=0.0, learn_jerk=learn_jerk)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    b = 128
    state = planted_state(tcfg, tprm, b, seed=3)
    limit = 80.0 if learn_jerk else 8.0
    act = np.random.default_rng(4).uniform(-limit, limit, (b, 2)).astype(np.float32)

    xs, _, xr, xt, _, xi = jpush.batched_step(jcfg, jprm, to_jax_state(state), jnp.asarray(act))
    ts, _, tr, tt, _, ti = tpush.make_fused_step(tcfg, tprm)(state, torch.from_numpy(act))
    assert_states_close(ts, xs, keys=('pos', 'vel', 'obj_pos', 'obj_vel'))
    np.testing.assert_allclose(ts.acc.numpy(), np.asarray(xs.acc), **TOL_ACC)
    np.testing.assert_allclose(ts.mover_z.numpy(), np.asarray(xs.mover_z), **TOL)
    np.testing.assert_array_equal(ti['wall_collision'].numpy(), np.asarray(xi['wall_collision']))
    assert (np.abs(ts.obj_pos.numpy() - state.obj_pos.numpy()) > 1e-5).any(), 'contact never fired'


def test_kernel_b_wrapper_checks_noise_count_and_clips_actions():
    cfg, prm = tpush.make_pushing_env(std_noise=0.0, num_cycles=3, device='cpu')
    state, _, _ = tpush.init_batch(cfg, prm, 5, torch.Generator().manual_seed(0))
    step = tpush.make_fused_step(cfg, prm)
    with pytest.raises(AssertionError, match='drew 12 noise planes but 13'):
        step(state, torch.zeros(5, 2), noise=torch.zeros(13, 5))
    # actions beyond a_max are clipped before the kernel: same result as at the limit
    s_big = step(state, torch.full((5, 2), 1e4), noise=torch.zeros(12, 5))[0]
    s_lim = step(state, torch.full((5, 2), float(prm.a_max)), noise=torch.zeros(12, 5))[0]
    torch.testing.assert_close(s_big.pos, s_lim.pos, rtol=0, atol=0)
