"""Port parity: kernel E (planning cycles) and the public ``make_fused_step``.

The plain version of kernel E is held against the JAX package's Pallas
``_step_kernel`` (interpret mode, injected uniforms) plane by plane, for
circle and box collision shapes on full and holed layouts, acc and jerk
actuation, with a quarter of the envs driven into a wall.  The public step
is held against the JAX public step on the same uniforms; its observation
noise comes from each package's own generator, so rewards are compared
where the goal distance is far from the threshold.  The CUDA kernel is held
against the plain version on the card in
``test_torch_planning_kernels_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan

# ulp-level: XLA contracts multiply-adds and its libm differs from PyTorch's
# (log, cos, sin in Box-Muller); planes that carry the clamp chain's
# (v' - v) / dt (act) amplify one ulp of v by 1/dt: rtol 1e-4, atol 1e-5
TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
CONFIGS = {
    'circle_full_acc': (np.ones((3, 3)), {}, False),
    'circle_holed_jerk': (np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]]), {}, True),
    'box_full_jerk': (np.ones((3, 3)), BOX, True),
    'box_lshape_acc': (np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]]), BOX, False),
}
KW = dict(std_noise=[2e-3, 5e-2, 1e-5], num_cycles=5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_pair(name, **kw):
    layout, coll, jerk = CONFIGS[name]
    kw = dict(KW, collision_params=coll, learn_jerk=jerk, **kw)
    jcfg, jprm = jplan.make_planning_env(layout, 1, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(layout, 1, device='cpu', **kw)
    return jcfg, jprm, tcfg, tprm


def wall_state(cfg, prm, b, seed=0):
    """init_batch; a quarter of the envs at the +x edge moving out (wall
    hits at various cycles), half with a nonzero acceleration/activation."""
    g = torch.Generator().manual_seed(seed)
    state, _, _ = tplan.init_batch(cfg, prm, b, g)
    q = b // 4
    pos, vel, acc = state.pos.clone(), state.vel.clone(), state.acc.clone()
    pos[:q, 0, 0] = torch.linspace(0.58, 0.64, q)
    vel[:q, 0] = torch.tensor([1.0, 0.1])
    vel[q:2 * q, 0] = torch.rand((q, 2), generator=g) - 0.5
    acc[q:3 * q, 0] = (torch.rand((2 * q, 2), generator=g) - 0.5) * 10
    return dataclasses.replace(state, pos=pos, vel=vel, acc=acc, act=acc.clone())


def to_jax_state(tstate, seed=0):
    d = tplan.state_to_numpy(tstate)
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    return jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()}, key=keys)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_plain_kernel_e_matches_pallas_plane_by_plane(name):
    jcfg, jprm, tcfg, tprm = make_pair(name)
    b = 200
    state = wall_state(tcfg, tprm, b, seed=1)
    rng = np.random.default_rng(2)
    lim = 80.0 if tcfg.learn_jerk else 8.0
    act = rng.uniform(-lim, lim, (b, 2)).astype(np.float32)
    kc = kplan.make_kernel_consts(tcfg, tprm)
    n = kplan.cycles_noise_planes(tcfg.num_cycles, kc.box)
    u = rng.random((n, b), dtype=np.float32)

    fused = pallas_step.make_fused_planning_cycles(jcfg, jprm, interpret=True, inject_noise=True)
    assert fused.noise_planes == n
    d = tplan.state_to_numpy(state)
    jp, jv, _, jact, jw = fused(*(jnp.asarray(d[k]) for k in ('pos', 'vel', 'acc', 'act')), jnp.asarray(act), 0,
                                noise=jnp.asarray(u))
    want = np.concatenate([np.asarray(x).reshape(b, 2).T for x in (jp, jv, jact)]
                          + [np.asarray(jw, np.float32)[None]])
    planes = torch.cat([tplan.state_to_planes(tcfg, state)[:6], torch.from_numpy(act.T.copy())])
    got = kplan.planning_cycles(planes, kc, uniforms=torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (kplan.N_CYCLES_OUT, b)
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], **TOL, err_msg=f'plane {i}')
    for i in (4, 5):
        np.testing.assert_allclose(got[i], want[i], **TOL_ACC, err_msg=f'plane {i}')
    np.testing.assert_array_equal(got[6], want[6], err_msg='wall')
    assert 0 < got[6].sum() < b


def test_public_fused_step_matches_jax():
    """Two steps on the holed layout in jerk mode, b = 200 (not a multiple
    of 128), from the same state each step."""
    jcfg, jprm, tcfg, tprm = make_pair('circle_holed_jerk', std_noise=[2e-4, 5e-2, 1e-5])
    b = 200
    state = wall_state(tcfg, tprm, b, seed=3)
    jstep = jplan.make_fused_step(jcfg, jprm, interpret=True, inject_noise=True)
    tstep = tplan.make_fused_step(tcfg, tprm)
    assert tstep.noise_planes == jstep.noise_planes
    jstep = jax.jit(jstep)  # traced once for both steps
    rng = np.random.default_rng(4)
    thr = float(tprm.threshold_pos)
    walls_seen = 0
    for t in range(2):
        act = rng.uniform(-80, 80, (b, 2)).astype(np.float32)
        u = rng.random((tstep.noise_planes, b), dtype=np.float32)
        js, jo, jr, jt, jtr, ji = jstep(to_jax_state(state, t), jnp.asarray(act), noise=jnp.asarray(u))
        ts, to, tr, tt, ttr, ti = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u),
                                        generator=torch.Generator().manual_seed(t))
        for k in ('pos', 'vel', 'goals'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL, err_msg=k)
        for k in ('acc', 'act'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL_ACC, err_msg=k)
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))
        np.testing.assert_array_equal(ti['wall_collision'].numpy(), np.asarray(ji['wall_collision']))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        assert to['observation'].shape == (b, 4) and to['achieved_goal'].shape == (b, 2)
        # observation noise differs between the packages (own generators):
        # compare the reward where the noiseless distance is 5 sigma away
        # from the threshold
        dist = np.linalg.norm(ts.pos.numpy()[:, 0] - ts.goals.numpy()[:, 0], axis=-1)
        far = np.abs(dist - thr) > 5 * 2e-4 * np.sqrt(2)
        np.testing.assert_array_equal(tr.numpy()[far], np.asarray(jr)[far])
        np.testing.assert_array_equal(tt.numpy()[far], np.asarray(jt)[far])
        assert set(np.unique(tr.numpy())) <= {50.0, -50.0, -1.0}
        walls_seen += int(ti['wall_collision'].sum())
        state = ts
    assert walls_seen > 0
