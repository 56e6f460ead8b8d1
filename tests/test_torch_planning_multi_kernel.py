"""Port parity: kernel H (the M-mover planning autoreset step) and its
constants.

The plain version of kernel H is held against the JAX package's Pallas
``_planning_multi_autoreset_kernel`` (interpret mode, injected uniforms,
``cand_k=2``, 4 cycles, 200 envs) over all ``18M + 6`` output planes, for
circle and box collision shapes on full and holed layouts, acc and jerk
actuation, per-mover sizes, M = 2 and 3, and per-mover ``accel_scale``.
Planted states make wall hits, head-on mover collisions and truncation
restarts fire in every case.  The CUDA kernel is held against the plain
version on the card in ``test_torch_planning_multi_kernels_gpu.py``.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from gymnasium_planar_robotics_tpu_torch.ops.kernels import walls
from test_torch_planning_params import _find_partial_kw
from torch_planning_multi_cases import CASES, actions, make_env, planted_state

PKG = Path(__file__).resolve().parents[1] / 'gymnasium_planar_robotics_tpu_torch'
# ulp-level, as for kernel F; planes downstream of the clamp chain's
# (v' - v) / dt (act, pre-reset act) at rtol 1e-4 / atol 1e-5; steps, flags,
# unreached count and trials exact
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


def jax_env(name, **kw):
    layout, m, coll, jerk, _, scale = CASES[name]
    cfg, prm = jplan.make_planning_env(layout, m, dtype=jnp.float32, collision_params=coll, learn_jerk=jerk,
                                       **dict(KW, **kw))
    if scale is not None:
        prm = dataclasses.replace(prm, accel_scale=jnp.asarray(np.asarray(scale), jnp.float32))
    return cfg, prm


def jax_planes(out) -> np.ndarray:
    """The Pallas wrapper's structured outputs back into ``18M + 6`` planes."""
    (P, V, A, G, steps), (s_v, s_ag), (f_v, f_ag, f_acc), wall, mover, unreached, stalled, trials = out
    planes = []
    for x in (P, V, A, G, steps, s_v, s_ag, f_v, f_ag, f_acc, wall, mover, unreached, stalled, trials):
        x = np.asarray(x).astype(np.float32)
        planes += list(x.reshape(x.shape[0], -1).T) if x.ndim == 3 else [x]
    return np.stack(planes)


@pytest.mark.parametrize('name', [n for n in CASES if CASES[n][1] <= 3])
def test_plain_kernel_h_matches_pallas_plane_by_plane(name):
    jcfg, jprm = jax_env(name)
    tcfg, tprm = make_env(name, **KW)
    m, b = tcfg.num_movers, 200
    state = planted_state(name, tcfg, tprm, b, seed=1)
    act = actions(tcfg, b, seed=2)
    mc = kmulti.make_multi_kernel_consts(tcfg, tprm, CAND_K)
    n = kmulti.multi_noise_planes(tcfg.num_cycles, m, CAND_K, mc.base.box)
    u = np.random.default_rng(3).random((n, b), dtype=np.float32)

    fused = pallas_step.make_fused_planning_multi_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K,
                                                                  inject_noise=True)
    assert fused.noise_planes == n
    d = tplan.state_to_numpy(state)
    a_in = d['act' if tcfg.learn_jerk else 'acc']
    want = jax_planes(fused(*(jnp.asarray(x) for x in (d['pos'], d['vel'], a_in, d['goals'], d['steps'], act)), 0,
                            noise=jnp.asarray(u)))
    got = kmulti.planning_multi_autoreset(tplan.state_to_planes(tcfg, state),
                                          torch.from_numpy(act.reshape(b, -1).T.copy()), mc,
                                          uniforms=torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (kmulti.n_multi_out(m), b)
    exact = {8 * m, *range(18 * m + 1, 18 * m + 6)}
    acc = {*range(4 * m, 6 * m), *range(16 * m + 1, 18 * m + 1)}
    for i in range(got.shape[0]):
        if i in exact:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f'plane {i}')
        else:
            np.testing.assert_allclose(got[i], want[i], **(TOL_ACC if i in acc else TOL), err_msg=f'plane {i}')
    # wall hits, mover collisions and restarts fired; some envs kept running
    restarted = (got[8 * m] == 0) & (d['steps'] > 0)
    assert got[18 * m + 1].sum() > 0 and got[18 * m + 2].sum() > 0 and restarted.sum() > 0
    assert (got[8 * m] > 0).any()


@pytest.mark.parametrize('name', ['circle_full_acc_m3', 'box_full_jerk_m2', 'circle_full_scaled_m2'])
def test_multi_constants_match_pallas(name):
    """Every per-mover size, pair sum and accel_scale is the f32 rounding of
    what the JAX wrapper binds (pair sums formed in float64), and the shared
    fields are kernel F's."""
    jcfg, jprm = jax_env(name)
    tcfg, tprm = make_env(name, **KW)
    kw = _find_partial_kw(pallas_step.make_fused_planning_multi_autoreset_cycles(jcfg, jprm, interpret=True,
                                                                                cand_k=3), 'reset_consts')
    rc, m = kw['reset_consts'], tcfg.num_movers
    mc = kmulti.make_multi_kernel_consts(tcfg, tprm, 3)
    f32 = walls.f32
    for size in ('c_wall', 'c_sample', 'c_sample_pair', 'c_pair'):
        want = [s if isinstance(s, tuple) else (s, s) for s in rc[size]]
        assert mc.f[size + '_x'][:m] == [f32(s[0]) for s in want], size
        assert mc.f[size + '_y'][:m] == [f32(s[1]) for s in want], size
    sizes = [s if isinstance(s, tuple) else (s, s) for s in rc['c_sample_pair']]
    pairs = kmulti.pairs(m)
    assert mc.f['sample_pair_sum_x'][:len(pairs)] == [f32(sizes[i][0] + sizes[j][0]) for i, j in pairs]
    assert mc.f['sample_pair_sum_y'][:len(pairs)] == [f32(sizes[i][1] + sizes[j][1]) for i, j in pairs]
    if not kw['box']:
        assert mc.f['pair_sum'][:len(pairs)] == [f32(rc['c_pair'][i] + rc['c_pair'][j]) for i, j in pairs]
    assert mc.f['accel_scale'][:m] == kw['accel_scale']
    assert mc.f['min_goal_dist'] == [f32(rc['min_goal_dist'])]
    base = mc.base.f
    for k in ('threshold', 'max_episode_steps', 'min_x', 'min_y'):
        assert base[k] == f32(rc[k]), k
    assert base['span_x'] == f32(rc['max_x'] - rc['min_x']) and base['span_y'] == f32(rc['max_y'] - rc['min_y'])
    for k in ('v_max', 'a_max', 'dt', 'std_pos', 'std_vel'):
        assert base[k] == f32(kw[k]), k
    assert (mc.base.num_cycles, mc.base.cand_k, mc.base.learn_jerk, mc.base.box) == (
        kw['num_cycles'], rc['cand_k'], kw['learn_jerk'], kw['box'])
    assert mc.vector.dtype == np.float32 and mc.vector.shape == (sum(n for _, n in kmulti.MULTI_FIELDS),)
    for cand_k in (2, 16):
        assert kmulti.multi_noise_planes(jcfg.num_cycles, m, cand_k, kw['box']) == \
            pallas_step._planning_multi_autoreset_noise_planes(jcfg.num_cycles, m, cand_k, kw['box'])


def test_multi_fields_match_cuda_struct():
    """The constants vector's (name, length) order is the X-macro order of
    gprt::MultiConsts in csrc/planning_multi.cuh, and its lengths are
    kMaxMovers and its pair count."""
    src = (PKG / 'csrc' / 'planning_multi.cuh').read_text()
    block = src.split('#define GPRT_MULTI_FIELDS(X)')[1].split('#define')[0]
    assert tuple((n, int(k)) for n, k in re.findall(r'X\((\w+), (\d+)\)', block)) == kmulti.MULTI_FIELDS
    assert f'kMaxMovers = {kmulti.MAX_MOVERS};' in src
