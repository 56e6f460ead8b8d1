"""Port parity: kernel C (pushing autoreset step) and
``make_fused_step_autoreset``.

The plain version of kernel C is held against the JAX package's Pallas
autoreset kernel (interpret mode, injected uniforms, ``cand_k=2``) plane by
plane over all 36 outputs, and the public step against the JAX public step
over three steps with restarts firing, one restart stalled by construction
and a batch that is not a multiple of 128.  Each step starts both packages
from the same state (the contact boundary is chaotic, so parity is judged
one step at a time).  The CUDA kernel is held against the plain version on
the card in ``test_torch_kernels_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

# ulp-level (FMA contraction differs between the programs); planes that
# carry the clamp chain's (v' - v) / dt (acc, act, pre-reset qacc) 1e-4
TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
ACC_PLANES = (4, 5, 6, 7, 31, 32)
KW = dict(std_noise=[2e-4, 5e-3, 1e-5], num_cycles=10)
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


def episode_state(cfg, prm, b, seed=0, device='cpu'):
    """init_batch, then: half the envs planted at the object (contact), a
    quarter near the -x wall moving out (wall termination), and step
    counters spread so that every 8th env truncates in the first step."""
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    h, q = b // 2, b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], device=device)
    vel[:h] = torch.tensor([0.4, 0.0], device=device)
    pos[h : h + q, 0] = 0.115
    vel[h : h + q] = torch.tensor([-1.0, 0.2], device=device)
    steps = torch.randint(0, 45, (b,), generator=g, device=device, dtype=torch.int32)
    steps[::8] = cfg.max_episode_steps - 1
    return dataclasses.replace(state, pos=pos, vel=vel, steps=steps)


def jax_raw_planes(out) -> np.ndarray:
    """The Pallas wrapper's structured outputs back into the 36 planes."""
    state, sel, fin, wall, stalled, trials = out
    planes = []
    for x in (*state, *sel, *fin, wall, stalled, trials):
        x = np.asarray(x).astype(np.float32)
        planes += [x[:, 0], x[:, 1]] if x.ndim == 2 else [x]
    return np.stack(planes)


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_kernel_c_matches_pallas_plane_by_plane(learn_jerk):
    kw = dict(KW, learn_jerk=learn_jerk)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    b = 128
    state = episode_state(tcfg, tprm, b, seed=1)
    limit = 80.0 if learn_jerk else 8.0
    rng = np.random.default_rng(2)
    act = rng.uniform(-limit, limit, (b, 2)).astype(np.float32)
    n = kpush.autoreset_noise_planes(tcfg.num_cycles, CAND_K)
    u = rng.random((n, b), dtype=np.float32)

    fused = pallas_step.make_fused_pushing_autoreset_cycles(
        jcfg, jprm, interpret=True, cand_k=CAND_K, inject_noise=True
    )
    assert fused.noise_planes == n
    d = tpush.state_to_numpy(state)
    want = jax_raw_planes(fused(
        *(jnp.asarray(d[k]) for k in ('pos', 'vel', 'acc', 'act', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w',
                                      'mover_z', 'mover_vz', 'goal', 'steps')),
        jnp.asarray(act), 0, noise=jnp.asarray(u),
    ))
    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    got = kpush.pushing_autoreset(tpush.state_to_planes(state), torch.from_numpy(act.T.copy()), kc,
                                  uniforms=torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (kpush.N_AUTORESET_OUT, b)
    for i in range(kpush.N_AUTORESET_OUT):
        np.testing.assert_allclose(got[i], want[i], **(TOL_ACC if i in ACC_PLANES else TOL), err_msg=f'plane {i}')
    # restarts fired (truncation and wall), some envs kept running
    restarted = (got[18] == 0) & (d['steps'] > 0)
    assert restarted.sum() >= b // 8 and (got[33] > 0).any() and (got[18] > 0).any()


def test_public_autoreset_step_matches_jax_over_three_steps():
    """b = 200 (not a multiple of 128); env 5 truncates in the first step
    and its restart stalls by construction: the injected uniforms put the
    new mover and both object candidates at the same point."""
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **KW)
    tcfg, tprm = tpush.make_pushing_env(**KW, device='cpu')
    b, stall_env = 200, 5
    state = episode_state(tcfg, tprm, b, seed=4)
    state.steps[stall_env] = tcfg.max_episode_steps - 1
    jstep = jpush.make_fused_step_autoreset(jcfg, jprm, interpret=True, inject_noise=True, cand_k=CAND_K)
    tstep = tpush.make_fused_step_autoreset(tcfg, tprm, cand_k=CAND_K)
    assert tstep.noise_planes == jstep.noise_planes
    rng = np.random.default_rng(5)
    restarts = stalls = 0
    for t in range(3):
        act = rng.uniform(-8, 8, (b, 2)).astype(np.float32)
        u = rng.random((tstep.noise_planes, b), dtype=np.float32)
        if t == 0:
            base = 4 * tcfg.num_cycles + 6  # after the cycles and the pre-reset obs
            u[base : base + 2 + 2 * CAND_K, stall_env] = 0.5  # mover, object, candidate
        js, jobs, jr, jt, jtr, ji = jstep(to_jax_state(state, t), jnp.asarray(act), noise=jnp.asarray(u))
        ts, tobs, tr, tt, ttr, ti = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u))

        for k in ('pos', 'vel', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w', 'mover_z', 'mover_vz', 'goal'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL, err_msg=k)
        for k in ('acc', 'act'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL_ACC, err_msg=k)
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
        for name, got, want in (('obs', tobs, jobs), ('final_observation', ti['final_observation'],
                                                      ji['final_observation'])):
            for k in ('observation', 'achieved_goal', 'desired_goal'):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=f'{name}.{k}')
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        for k in ('is_success', 'wall_collision', 'mover_collision', 'reset_stalled', 'reset_trials'):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
        assert ts.pos.shape == (b, 2) and tr.shape == (b,) and ts.steps.dtype == torch.int32
        assert set(np.unique(tr.numpy())) <= {0.0, -1.0, -50.0}
        if t == 0:
            assert bool(ti['reset_stalled'][stall_env]) and int(ti['reset_trials'][stall_env]) == CAND_K
            assert int(ts.steps[stall_env]) == tcfg.max_episode_steps  # not reset: retried next step
        done = (tt | ttr).numpy() & ~ti['reset_stalled'].numpy()
        restarts += int(done.sum())
        stalls += int(ti['reset_stalled'].sum())
        assert (ts.steps.numpy()[done] == 0).all()
        state = ts
    assert restarts > b // 8 and stalls >= 1
