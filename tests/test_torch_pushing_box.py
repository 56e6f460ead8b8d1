"""Port parity: pushing with the box collision shape and mesh movers.

The plain box versions of kernels B, C, C-feat and D are held against the
JAX package's Pallas kernels in interpret mode: B and C (and C-feat's
blocks, assembled from kernel C's planes) on injected uniforms, C-feat's own
blocks and D (K=2) on the all-zero bits interpret mode's hardware PRNG gives
(the plain versions then get all-zero uniforms).  The eager ``step`` /
``step_autoreset`` and the reset's wall check are held against the JAX
package's XLA path on JAX's own normals (each env's key split as
``pushing._step_core``, ``reset`` and ``_get_obs`` split it).  Every case
drives some envs into a wall and asserts that some hit it.

Tolerances are those of the circle's tests: planes at rtol 2e-6 / atol 2e-6
(``test_torch_pushing_cycles.TOL``; the programs contract multiply-adds
differently and contact amplifies an ulp), planes downstream of the clamp
chain's ``(v' - v) / dt`` at rtol 1e-4 / atol 1e-5 (``TOL_ACC``); the eager
step at float64 rtol 1e-9 / atol 1e-9 (1e-8 on accelerations) and float32
at the eager tolerances (``test_torch_pushing_step.tols``); wall flags,
step counters and rewards equal.
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

from test_torch_pushing_autoreset import ACC_PLANES, jax_raw_planes
from test_torch_pushing_cycles import TOL, TOL_ACC, assert_states_close
from test_torch_pushing_features import numpy_features
from test_torch_pushing_step import LEAVES, assert_obs, tols

BOX = {'shape': 'box', 'size': [0.1, 0.1]}
MESH_BUMPER = {'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}  # tests/test_pushing_env.py:288
NOISE = [2e-4, 5e-3, 1e-5]
CAND_K = 2
B = 128
STATE_KEYS = ('pos', 'vel', 'acc', 'act', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w', 'mover_z', 'mover_vz', 'goal',
              'steps')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def envs(dtype='float32', mesh=False, **kw):
    kw = {'collision_params': BOX, **kw}
    if mesh:
        kw['mover_params'] = MESH_BUMPER
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.dtype(dtype), **kw)
    tcfg, tprm = tpush.make_pushing_env(dtype=getattr(torch, dtype), device='cpu', **kw)
    return jcfg, jprm, tcfg, tprm


def wall_state(cfg, prm, b, seed, spread_steps=False):
    """init_batch; half the envs planted at the object's -x face moving into
    it (contact), a quarter with the box's -x side within a centimetre of
    the -x wall moving out (wall hits inside the step), every 8th about to
    truncate when ``spread_steps``."""
    g = torch.Generator().manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    dt = state.pos.dtype
    h, q = b // 2, b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], dtype=dt)
    vel[:h] = torch.tensor([0.4, 0.0], dtype=dt)
    pos[h:h + q, 0] = torch.linspace(0.1, 0.11, q, dtype=dt)
    vel[h:h + q] = torch.tensor([-1.0, 0.2], dtype=dt)
    steps = state.steps
    if spread_steps:
        steps = torch.randint(0, 45, (b,), generator=g, dtype=torch.int32)
        steps[::8] = cfg.max_episode_steps - 1
    return dataclasses.replace(state, pos=pos, vel=vel, steps=steps)


def to_jax_state(tstate, seed=0):
    d = tpush.state_to_numpy(tstate)
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    return jpush.PushingState(**{k: jnp.asarray(v) for k, v in d.items()}, key=keys)


def jax_kernel_c(jcfg, jprm, state, act, u):
    """The 36 output planes of the JAX Pallas kernel C (interpret mode,
    injected uniforms)."""
    fused = pallas_step.make_fused_pushing_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K,
                                                            inject_noise=True)
    assert fused.noise_planes == u.shape[0]
    d = tpush.state_to_numpy(state)
    return jax_raw_planes(fused(*(jnp.asarray(d[k]) for k in STATE_KEYS), jnp.asarray(act), 0, noise=jnp.asarray(u)))


def assert_planes(got, want, acc_planes):
    for i in range(want.shape[0]):
        np.testing.assert_allclose(got[i], want[i], **(TOL_ACC if i in acc_planes else TOL), err_msg=f'plane {i}')


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_box_kernel_b_matches_pallas_injected(learn_jerk):
    jcfg, jprm, tcfg, tprm = envs(std_noise=NOISE, num_cycles=10, learn_jerk=learn_jerk)
    state = wall_state(tcfg, tprm, B, seed=0)
    limit = 80.0 if learn_jerk else 8.0
    rng = np.random.default_rng(1)
    act = rng.uniform(-limit, limit, (B, 2)).astype(np.float32)
    tstep = tpush.make_fused_step(tcfg, tprm)
    assert tstep.noise_planes == kpush.cycles_noise_planes(10, box=True) == 80
    u = rng.random((tstep.noise_planes, B), dtype=np.float32)
    jstep = jpush.make_fused_step(jcfg, jprm, interpret=True, inject_noise=True)
    assert jstep.noise_planes == tstep.noise_planes
    js, _, jr, jt, _, ji = jstep(to_jax_state(state), jnp.asarray(act), noise=jnp.asarray(u))
    ts, _, tr, tt, _, ti = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u),
                                 generator=torch.Generator().manual_seed(2))
    assert_states_close(ts, js)
    wall = ti['wall_collision'].numpy()
    np.testing.assert_array_equal(wall, np.asarray(ji['wall_collision']))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert 0 < wall.sum() < B
    assert (np.abs(ts.obj_pos.numpy() - state.obj_pos.numpy()) > 1e-5).any(), 'contact never fired'


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_box_kernel_c_matches_pallas_plane_by_plane(learn_jerk):
    jcfg, jprm, tcfg, tprm = envs(std_noise=NOISE, num_cycles=10, learn_jerk=learn_jerk)
    state = wall_state(tcfg, tprm, B, seed=1, spread_steps=True)
    limit = 80.0 if learn_jerk else 8.0
    rng = np.random.default_rng(3)
    act = rng.uniform(-limit, limit, (B, 2)).astype(np.float32)
    n = kpush.autoreset_noise_planes(10, CAND_K, box=True)
    assert n == 8 * 10 + 16 + 2 * CAND_K
    u = rng.random((n, B), dtype=np.float32)
    want = jax_kernel_c(jcfg, jprm, state, act, u)
    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    got = kpush.pushing_autoreset(tpush.state_to_planes(state), torch.from_numpy(act.T.copy()), kc,
                                  uniforms=torch.from_numpy(u)).numpy()
    assert_planes(got, want, ACC_PLANES)
    restarted = (got[18] == 0) & (state.steps.numpy() > 0)
    assert restarted.sum() >= B // 8 and 0 < (got[33] > 0).sum() < B


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_box_c_feat_matches_pallas_injected(learn_jerk):
    """C-feat's blocks against the numpy assembly of the JAX kernel C's planes
    (injected uniforms); its 36 planes equal kernel C's."""
    jcfg, jprm, tcfg, tprm = envs(std_noise=NOISE, num_cycles=10, learn_jerk=learn_jerk, mesh=True)
    state = wall_state(tcfg, tprm, B, seed=2, spread_steps=True)
    rng = np.random.default_rng(4)
    act = rng.uniform(-8.0, 8.0, (B, 2)).astype(np.float32)
    u = rng.random((kpush.autoreset_noise_planes(10, CAND_K, box=True), B), dtype=np.float32)
    st = tpush.state_to_planes(state)
    want = numpy_features(st.numpy(), jax_kernel_c(jcfg, jprm, state, act, u))
    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    action, uniforms = torch.from_numpy(act.T.copy()), torch.from_numpy(u)
    out, feat = kpush.pushing_autoreset(st, action, kc, uniforms=uniforms, emit_features=True)
    torch.testing.assert_close(out, kpush.pushing_autoreset(st, action, kc, uniforms=uniforms), rtol=0, atol=0)
    np.testing.assert_allclose(feat.numpy(), want, **TOL)
    assert 0 < int((out[33] > 0).sum()) < B


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_box_c_feat_matches_the_pallas_emit_features_kernel(learn_jerk):
    """The JAX kernel's own ``emit_features`` build (its hardware PRNG gives
    all-zero bits in interpret mode) against the plain C-feat on all-zero
    uniforms: identity rotation, no noise, the box's wall rule alone."""
    jcfg, jprm, tcfg, tprm = envs(num_cycles=6, learn_jerk=learn_jerk)
    state = wall_state(tcfg, tprm, B, seed=3, spread_steps=True)
    act = np.random.default_rng(5).uniform(-8.0, 8.0, (2, B)).astype(np.float32)
    st = tpush.state_to_planes(state)
    fused = pallas_step.make_fused_pushing_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K,
                                                            emit_features=True)
    outs = fused.raw_planes([jnp.asarray(p.numpy().reshape(1, B)) for p in st],
                            (jnp.asarray(act[0].reshape(1, B)), jnp.asarray(act[1].reshape(1, B))), 0)
    jout = np.stack([np.asarray(o).reshape(B) for o in outs[:kpush.N_AUTORESET_OUT]])
    jfeat = np.stack([np.asarray(outs[36]).reshape(kpush.N_FEATURES, B),
                      np.asarray(outs[37]).reshape(kpush.N_FEATURES, B)])
    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    zeros = torch.zeros((kpush.autoreset_noise_planes(6, CAND_K, box=True), B))
    out, feat = kpush.pushing_autoreset(st, torch.from_numpy(act), kc, uniforms=zeros, emit_features=True)
    np.testing.assert_allclose(feat.numpy(), jfeat, **TOL)
    assert_planes(out.numpy(), jout, ACC_PLANES)
    np.testing.assert_array_equal(out[33].numpy(), jout[33])
    assert 0 < jout[33].sum() < B


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_box_kernel_d_matches_pallas_rollout_k2(learn_jerk):
    """Kernel D at K=2 (``raw_rollout``; all-zero hardware bits in interpret
    mode) against the plain version on all-zero uniforms: final state and
    the per-step wall, reached and truncation signals."""
    jcfg, jprm, tcfg, tprm = envs(num_cycles=8, learn_jerk=learn_jerk, mesh=True)
    state = wall_state(tcfg, tprm, B, seed=4, spread_steps=True)
    K = 2
    limit = 80.0 if learn_jerk else 8.0
    acts = np.random.default_rng(6).uniform(-limit, limit, (K, 2, B)).astype(np.float32)
    st = tpush.state_to_planes(state)
    fused = pallas_step.make_fused_pushing_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K)
    jouts = fused.raw_rollout(K)([jnp.asarray(p.numpy().reshape(1, B)) for p in st],
                                 (jnp.asarray(acts[:, 0].reshape(K, 1, B)), jnp.asarray(acts[:, 1].reshape(K, 1, B))),
                                 0)
    jst = np.stack([np.asarray(o).reshape(B) for o in jouts[:kpush.N_STATE]])
    jsig = np.stack([np.asarray(o).reshape(K, B) for o in jouts[kpush.N_STATE:]])
    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    zeros = torch.zeros((K * kpush.autoreset_noise_planes(8, CAND_K, box=True), B))
    got_st, got_sig = kpush.pushing_rollout(st, torch.from_numpy(acts), kc, uniforms=zeros)
    assert_planes(got_st.numpy(), jst, (4, 5, 6, 7))
    np.testing.assert_array_equal(got_sig.numpy(), jsig)
    assert 0 < jsig[0].sum() < K * B and jsig[2].sum() > 0


def test_rollout_and_reactive_paths_run_the_box():
    """``make_fused_rollout`` at K=1 and K=2 and ``make_reactive_rollout``
    accept the box with mesh movers; on all-zero uniforms the reactive
    rollout under a constant policy is the K=1 rollout."""
    _, _, tcfg, tprm = envs(std_noise=0.0, num_cycles=6, mesh=True)
    state = wall_state(tcfg, tprm, B, seed=5)
    T = 3
    acts = torch.tensor([1.5, -0.5]).expand(T, B, 2)
    r1 = tpush.make_fused_rollout(tcfg, tprm, cand_k=CAND_K)(state, acts, 3)
    r2 = tpush.make_fused_rollout(tcfg, tprm, cand_k=CAND_K, steps_per_launch=2)(state, acts, 3)
    live = ~(r1[2].any(0) | r1[3].any(0) | r2[2].any(0) | r2[3].any(0))
    assert r1[2].any() and live.sum() > B // 2
    for k in ('pos', 'vel', 'obj_pos', 'mover_z'):
        torch.testing.assert_close(getattr(r2[0], k)[live], getattr(r1[0], k)[live], rtol=0, atol=0)

    def policy_step(pol, gen, obs_pm):
        return torch.tensor([1.5, -0.5])[:, None].expand(2, obs_pm.shape[1]).contiguous(), torch.zeros(obs_pm.shape[1])

    react = tpush.make_reactive_rollout(tcfg, tprm, policy_step, T, cand_k=CAND_K)
    fs, traj, _ = react(state, None, None, 3)
    torch.testing.assert_close(traj[3], r1[2], rtol=0, atol=0)
    torch.testing.assert_close(fs.pos[live], r1[0].pos[live], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the eager step and the reset against the XLA path
# ---------------------------------------------------------------------------


def jax_step_noise(keys, num_cycles, dtype) -> dict:
    """The standard normals the JAX step draws from each env's key
    (``_step_core``, ``_get_obs``), in the port's layout: the box's pose
    rows are 6-dimensional."""
    dt = jnp.dtype(dtype)

    def one(k):
        _, k_cycles, k_obs = jax.random.split(k, 3)
        k_vel, k_wall = jax.random.split(k_cycles)
        obs = jnp.concatenate([jax.random.normal(kk, (2,), dt) for kk in jax.random.split(k_obs, 3)])
        return jax.random.normal(k_vel, (num_cycles, 2), dt), jax.random.normal(k_wall, (num_cycles, 6), dt), obs

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


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('mode', ['acc', 'jerk_mesh'])
def test_box_step_matches_jax_with_its_noise(mode, dtype):
    jerk = mode.startswith('jerk')
    jcfg, jprm, tcfg, tprm = envs(dtype, mesh=mode.endswith('mesh'), std_noise=NOISE, learn_jerk=jerk)
    state = wall_state(tcfg, tprm, 96, seed=6)
    jstate = to_jax_state(state, 7)
    limit = 80.0 if jerk else 8.0
    act = np.random.default_rng(8).uniform(-limit, limit, (96, 2)).astype(dtype)
    xs, xo, xr, xt, _, xi = jax.jit(lambda s, a: jpush.batched_step(jcfg, jprm, s, a))(jstate, jnp.asarray(act))
    noise = jax_step_noise(jstate.key, tcfg.num_cycles, dtype)
    assert tpush.draw_step_noise(tcfg, 96, getattr(torch, dtype), 'cpu')['pose'].shape == noise['pose'].shape
    ts, to, tr, tt, _, ti = tpush.step(tcfg, tprm, state, torch.from_numpy(act), noise=noise)
    assert_states(ts, xs, dtype)
    assert_obs(to, xo, dtype)
    np.testing.assert_allclose(tr.numpy(), np.asarray(xr), **tols(dtype)[0])
    for k in ('is_success', 'wall_collision'):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(xi[k]), err_msg=k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(xt))
    wall = ti['wall_collision'].numpy()
    assert 0 < wall.sum() < 96 and (np.abs(ts.obj_pos.numpy() - state.obj_pos.numpy()) > 1e-5).any()


def test_box_step_autoreset_matches_jax_over_30_steps():
    """``step_autoreset`` (float64, mesh mover, ``std_noise > 0``) for 30
    steps: every env that has not ended an episode matches JAX, an ending
    env carries JAX's pre-reset observation; wall hits end episodes."""
    jcfg, jprm, tcfg, tprm = envs('float64', mesh=True, std_noise=NOISE)
    b = 48
    state = wall_state(tcfg, tprm, b, seed=9)
    state.steps[::6] = tcfg.max_episode_steps - 3
    jstate = to_jax_state(state, 10)
    jstep = jax.jit(lambda s, a: jpush.batched_step_autoreset(jcfg, jprm, s, a))
    g = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(12)
    live = np.ones(b, bool)
    ends = {'terminated': 0, 'truncated': 0}
    for _ in range(30):
        act = rng.uniform(-6.0, 6.0, (b, 2))
        noise = jax_step_noise(jstate.key, tcfg.num_cycles, 'float64')
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
        live &= ~done
        assert_states(state, jstate, 'float64', live)
        assert_obs(to, xo, 'float64', live)
        if done.any():
            assert (state.steps.numpy()[done] == 0).all() and (state.vel.numpy()[done] == 0).all()
    assert ends['terminated'] > 0 and ends['truncated'] > 0 and live.any(), ends


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_box_reset_wall_check_matches_jax(dtype):
    """The reset's noisy wall check with the 6-dimensional pose noise (xy and
    the quaternion around the identity), on starts pinned across the
    collision margin of the -x wall, and the first observation."""
    jcfg, jprm, tcfg, tprm = envs(dtype, std_noise=[3e-3, 1e-3, 1e-5],
                                  collision_params={'shape': 'box', 'size': [0.1, 0.09], 'offset': 0.005})
    b = 64
    margin = float(tprm.c_size[0, 0] + tprm.c_offset)
    starts = np.stack([np.linspace(margin - 0.006, margin + 0.006, b), np.linspace(0.2, 0.5, b)], -1).astype(dtype)
    keys = jax.random.split(jax.random.PRNGKey(13), b)
    js, jo, ji = jax.vmap(lambda k, m: jpush.reset(jcfg, jprm, k, mover_start_xy_pos=m))(keys, jnp.asarray(starts))

    def one(k):
        _, _, _, _, k_noise, _ = jax.random.split(k, 6)
        k_wall, k_obs = jax.random.split(k_noise)
        obs = jnp.concatenate([jax.random.normal(kk, (2,), jnp.dtype(dtype)) for kk in jax.random.split(k_obs, 3)])
        return jax.random.normal(k_wall, (6,), jnp.dtype(dtype)), obs

    pose, obs = (np.asarray(x) for x in jax.vmap(one)(keys))
    ts, to, ti = tpush.reset(tcfg, tprm, b, torch.Generator().manual_seed(14),
                             mover_start_xy_pos=torch.from_numpy(starts),
                             noise={'pose': torch.from_numpy(pose.copy()), 'obs': torch.from_numpy(obs.T.copy())})
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    wall = ti['wall_collision'].numpy()
    np.testing.assert_array_equal(wall, np.asarray(ji['wall_collision']))
    np.testing.assert_allclose(to['observation'].numpy(), np.asarray(jo['observation']), **tols(dtype)[0])
    assert 0 < wall.sum() < b
