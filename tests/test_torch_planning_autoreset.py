"""Port parity: kernel F (planning autoreset step) and the public
``make_fused_step_autoreset``.

The plain version of kernel F is held against the JAX package's Pallas
``_planning_autoreset_kernel`` (interpret mode, injected uniforms,
``cand_k=2``) over all 23 output planes, for circle and box collision
shapes on full and holed layouts, acc and jerk actuation.  The public step
is held against the JAX public step over three steps with wall hits,
truncation restarts, one restart stalled by construction and a batch that
is not a multiple of 128, in sparse and dense reward modes.  Each step
starts both packages from the same state.  The CUDA kernel is held against
the plain version on the card in ``test_torch_planning_kernels_gpu.py``.

On holed layouts the Pallas rule compares positions against NumPy float64
tile edges, which the suite's x64 mode keeps in float64; a chip, and the
port, compare against their f32 roundings.  Where an edge is a rounding tie
(0.36f - 0.12f = 0.24000001698732376) a position exactly on the rounded
edge covers a tile on the chip but falls between two tiles in float64, and
the two flag it differently.  A seed of this test once put a noisy box
centre there (y = 0.24000000953674316); the seeds below do not, and
``test_torch_planning_walls.test_rounding_tie_edge_follows_f32`` pins the
difference on that point.
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

# ulp-level (XLA contracts multiply-adds, its libm differs from PyTorch's);
# planes that carry the clamp chain's (v' - v) / dt (act, pre-reset act)
# amplify one ulp of v by 1/dt; flags, steps and trials exact
TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
ACC_PLANES = (4, 5, 17, 18)
EXACT_PLANES = (8, 19, 20, 21, 22)
CAND_K = 2
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
HOLED = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
CONFIGS = {
    'circle_full_jerk': (np.ones((3, 3)), {}, True),
    'circle_holed_acc': (HOLED, {}, False),
    'box_full_acc': (np.ones((3, 3)), BOX, False),
    'box_lshape_jerk': (np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]]), BOX, True),
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


def episode_state(cfg, prm, b, seed=0):
    """init_batch; a quarter of the envs at the +x edge moving out (wall
    hits), every 8th about to truncate, step counters spread, half with a
    nonzero acceleration/activation."""
    g = torch.Generator().manual_seed(seed)
    state, _, _ = tplan.init_batch(cfg, prm, b, g)
    q = b // 4
    pos, vel, acc = state.pos.clone(), state.vel.clone(), state.acc.clone()
    pos[:q, 0, 0] = torch.linspace(0.58, 0.64, q)
    vel[:q, 0] = torch.tensor([1.0, 0.1])
    acc[q:3 * q, 0] = (torch.rand((2 * q, 2), generator=g) - 0.5) * 10
    steps = torch.randint(0, 45, (b,), generator=g, dtype=torch.int32)
    steps[::8] = cfg.max_episode_steps - 1
    return dataclasses.replace(state, pos=pos, vel=vel, acc=acc, act=acc.clone(), steps=steps)


def to_jax_state(tstate, seed=0):
    d = tplan.state_to_numpy(tstate)
    keys = jax.random.split(jax.random.PRNGKey(seed), d['pos'].shape[0])
    return jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()}, key=keys)


def jax_raw_planes(out) -> np.ndarray:
    """The Pallas wrapper's structured outputs back into the 23 planes."""
    (pos, vel, acc, goals, steps), (s_v, s_ag), (f_v, f_ag, f_acc), wall, reached, stalled, trials = out
    planes = []
    for x in (pos, vel, acc, goals, steps, s_v, s_ag, f_v, f_ag, f_acc, wall, reached, stalled, trials):
        x = np.asarray(x).astype(np.float32)
        planes += [x[:, 0], x[:, 1]] if x.ndim == 2 else [x]
    return np.stack(planes)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_plain_kernel_f_matches_pallas_plane_by_plane(name):
    jcfg, jprm, tcfg, tprm = make_pair(name)
    b = 200
    state = episode_state(tcfg, tprm, b, seed=1)
    rng = np.random.default_rng(2)
    lim = 80.0 if tcfg.learn_jerk else 8.0
    act = rng.uniform(-lim, lim, (b, 2)).astype(np.float32)
    kc = kplan.make_kernel_consts(tcfg, tprm, CAND_K)
    n = kplan.autoreset_noise_planes(tcfg.num_cycles, CAND_K, kc.box)
    u = rng.random((n, b), dtype=np.float32)

    fused = pallas_step.make_fused_planning_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K,
                                                            inject_noise=True)
    assert fused.noise_planes == n
    d = tplan.state_to_numpy(state)
    a_state = d['act' if tcfg.learn_jerk else 'acc'][:, 0]
    want = jax_raw_planes(fused(jnp.asarray(d['pos'][:, 0]), jnp.asarray(d['vel'][:, 0]), jnp.asarray(a_state),
                                jnp.asarray(d['goals'][:, 0]), jnp.asarray(d['steps']), jnp.asarray(act), 0,
                                noise=jnp.asarray(u)))
    got = kplan.planning_autoreset(tplan.state_to_planes(tcfg, state), torch.from_numpy(act.T.copy()), kc,
                                   uniforms=torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (kplan.N_AUTORESET_OUT, b)
    for i in range(kplan.N_AUTORESET_OUT):
        if i in EXACT_PLANES:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f'plane {i}')
        else:
            np.testing.assert_allclose(got[i], want[i], **(TOL_ACC if i in ACC_PLANES else TOL),
                                       err_msg=f'plane {i}')
    # restarts fired (truncation and wall), walls hit, some envs kept running
    restarted = (got[8] == 0) & (d['steps'] > 0)
    assert restarted.sum() >= b // 8 and got[19].sum() > 0 and (got[8] > 0).any()


@pytest.mark.parametrize('reward_mode', ['sparse', 'dense'])
def test_public_autoreset_step_matches_jax_over_three_steps(reward_mode):
    """b = 200 on the holed layout; env 5 truncates in the first step and
    its restart stalls by construction: every sampling draw lands in the
    missing tile."""
    name = 'circle_holed_acc' if reward_mode == 'sparse' else 'box_full_acc'
    jcfg, jprm, tcfg, tprm = make_pair(name, reward_mode=reward_mode)
    b, stall_env = 200, 5
    state = episode_state(tcfg, tprm, b, seed=4)
    state.steps[stall_env] = tcfg.max_episode_steps - 1
    jstep = jplan.make_fused_step_autoreset(jcfg, jprm, interpret=True, inject_noise=True, cand_k=CAND_K)
    tstep = tplan.make_fused_step_autoreset(tcfg, tprm, cand_k=CAND_K)
    assert tstep.noise_planes == jstep.noise_planes
    jstep = jax.jit(jstep)  # traced once for the three steps
    box = tcfg.collision_shape == 'box'
    rng = np.random.default_rng(5)
    restarts = stalls = 0
    for t in range(3):
        lim = 80.0 if tcfg.learn_jerk else 8.0
        act = rng.uniform(-lim, lim, (b, 2)).astype(np.float32)
        u = rng.random((tstep.noise_planes, b), dtype=np.float32)
        if t == 0 and not box:
            # start and goal samplers: x at the box centre (0.36), y at 0.6,
            # inside the missing tile (1, 2) of the holed layout
            base = kplan.cycles_noise_planes(tcfg.num_cycles) + 4
            u[base : base + 4 * CAND_K : 2, stall_env] = 0.5
            u[base + 1 : base + 4 * CAND_K : 2, stall_env] = 0.98
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
                tol = TOL_ACC if k == 'observation' and tcfg.learn_jerk else TOL
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **tol, err_msg=f'{nm}.{k}')
        if reward_mode == 'dense':
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
        else:
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        for k in ('is_success', 'wall_collision', 'mover_collision', 'reset_stalled', 'reset_trials'):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
        assert ts.pos.shape == (b, 1, 2) and tr.shape == (b,) and ts.steps.dtype == torch.int32
        if t == 0 and not box:
            assert bool(ti['reset_stalled'][stall_env]) and int(ti['reset_trials'][stall_env]) == 2 * CAND_K
            assert int(ts.steps[stall_env]) == tcfg.max_episode_steps  # not reset: retried next step
        done = (tt | ttr).numpy() & ~ti['reset_stalled'].numpy()
        restarts += int(done.sum())
        stalls += int(ti['reset_stalled'].sum())
        assert (ts.steps.numpy()[done] == 0).all()
        state = ts
    assert restarts > b // 8
    if reward_mode == 'sparse':
        assert stalls >= 1
    else:
        assert (tr.numpy() < 0).any() and (tr.numpy() > -50).any()
