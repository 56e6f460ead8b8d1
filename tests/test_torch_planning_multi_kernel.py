"""Port parity: kernel H (the M-mover planning autoreset step) and its
constants.

The plain version of kernel H is held against the JAX package's Pallas
``_planning_multi_autoreset_kernel`` (interpret mode, injected uniforms,
``cand_k=2``, 4 cycles, 200 envs) over all ``18M + 6`` output planes, for
circle and box collision shapes on full and holed layouts, acc and jerk
actuation, per-mover sizes, M = 2 and 3, and per-mover ``accel_scale``; and
at M = 9 (circle and box on the full 6x6 table, 3 cycles, 64 envs).
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
from torch_planning_multi_cases import CASES, actions, case, make_env, plant_accepted_sets, planted_state

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
    layout, m, coll, jerk, _, scale = case(name)
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


def check_plain_against_pallas(name, b, cand_k, plant=False, plant_k=1, **kw):
    """The plain kernel H against the Pallas kernel (interpret mode, the
    same injected uniforms) over all 18M + 6 planes; with ``plant`` every
    other env accepts its start and goal sets number ``plant_k``."""
    jcfg, jprm = jax_env(name, **kw)
    tcfg, tprm = make_env(name, **dict(KW, **kw))
    m = tcfg.num_movers
    state = planted_state(name, tcfg, tprm, b, seed=1)
    act = actions(tcfg, b, seed=2)
    mc = kmulti.make_multi_kernel_consts(tcfg, tprm, cand_k)
    n = kmulti.multi_noise_planes(tcfg.num_cycles, m, cand_k, mc.base.box)
    u = np.random.default_rng(3).random((n, b), dtype=np.float32)
    if plant:
        plant_accepted_sets(u, name, tcfg, tprm, cand_k, np.arange(0, b, 2), k=plant_k)

    fused = pallas_step.make_fused_planning_multi_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=cand_k,
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
    return got


@pytest.mark.parametrize('name', [n for n in CASES if CASES[n][1] <= 3])
def test_plain_kernel_h_matches_pallas_plane_by_plane(name):
    check_plain_against_pallas(name, 200, CAND_K)


@pytest.mark.parametrize('name, cycles', [('circle_full_acc_m9', 3), ('box_full_jerk_m9', 2)])
def test_plain_kernel_h_matches_pallas_at_nine_movers(name, cycles):
    """More movers than one thread per env was instantiated for: 9 on the
    full 6x6 table (per-mover radii; per-mover box sizes with per-mover
    accel_scale, jerk), 64 envs; restarts accept a planted second set, and a
    stalled restart (all sets rejected) reports 2 cand_k trials."""
    got = check_plain_against_pallas(name, 64, CAND_K, plant=True, num_cycles=cycles)
    m = 9
    stalled = got[18 * m + 4] > 0
    assert stalled.any() and (got[18 * m + 5][stalled] == 2 * CAND_K).all()


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
        assert mc.f[size + '_x'] == [f32(s[0]) for s in want], size
        assert mc.f[size + '_y'] == [f32(s[1]) for s in want], size
    sizes = [s if isinstance(s, tuple) else (s, s) for s in rc['c_sample_pair']]
    pairs = kmulti.pairs(m)
    assert mc.f['sample_pair_sum_x'] == [f32(sizes[i][0] + sizes[j][0]) for i, j in pairs]
    assert mc.f['sample_pair_sum_y'] == [f32(sizes[i][1] + sizes[j][1]) for i, j in pairs]
    if not kw['box']:
        assert mc.f['pair_sum'] == [f32(rc['c_pair'][i] + rc['c_pair'][j]) for i, j in pairs]
    assert mc.f['accel_scale'] == kw['accel_scale']
    assert mc.f['min_goal_dist'] == [f32(rc['min_goal_dist'])]
    base = mc.base.f
    for k in ('threshold', 'max_episode_steps', 'min_x', 'min_y'):
        assert base[k] == f32(rc[k]), k
    assert base['span_x'] == f32(rc['max_x'] - rc['min_x']) and base['span_y'] == f32(rc['max_y'] - rc['min_y'])
    for k in ('v_max', 'a_max', 'dt', 'std_pos', 'std_vel'):
        assert base[k] == f32(kw[k]), k
    assert (mc.base.num_cycles, mc.base.cand_k, mc.base.learn_jerk, mc.base.box) == (
        kw['num_cycles'], rc['cand_k'], kw['learn_jerk'], kw['box'])
    assert mc.vector.dtype == np.float32 and mc.vector.shape == (
        sum(kmulti.field_length(rule, m) for _, rule in kmulti.MULTI_FIELDS),)
    for cand_k in (2, 16):
        assert kmulti.multi_noise_planes(jcfg.num_cycles, m, cand_k, kw['box']) == \
            pallas_step._planning_multi_autoreset_noise_planes(jcfg.num_cycles, m, cand_k, kw['box'])


@pytest.mark.parametrize('b', [1, 4096, kmulti.WIDE_BATCH, kmulti.WIDE_BATCH + 1, 65536])
def test_lane_layout_covers_the_movers(b):
    """The wrapper's (G, L) for every M it takes and width B is one of the
    layouts the kernel is held to on the card: up to ``SLOT_MOVERS``, G
    lanes (a power of two up to 32) with the fewest L slots each (an
    instantiated L) that hold all M movers, then the many-mover variant (one
    warp, L = ``SMEM_SLOTS``), which runs any M and is the only layout above
    ``SLOT_MOVERS``; its largest block (four envs) fits the card's shared
    memory at every M up to ``MAX_MOVERS``; beyond
    ``MAX_MOVERS`` (and below 2) it raises, naming the bound and the
    bytes."""
    many = (32, kmulti.SMEM_SLOTS)
    for m in range(2, kmulti.MAX_MOVERS + 1):
        g, n = kmulti.lane_layout(m, b)
        assert (g, n) in kmulti.layouts(m) and kmulti.layouts(m)[-1] == many
        if m > kmulti.SLOT_MOVERS:
            assert kmulti.layouts(m) == (many,), m
        slots = [lay for lay in kmulti.layouts(m) if lay != many]
        assert (g, n) == many or (g, n) in slots, (m, g, n)
        assert all(lg * ln >= m and lg in kmulti.LANES and ln in kmulti.SLOTS and (
            ln == kmulti.SLOTS[0] or lg * kmulti.SLOTS[kmulti.SLOTS.index(ln) - 1] < m) for lg, ln in slots)
        for box in (False, True):
            assert kmulti.many_smem_bytes(m, box) == 4 * kmulti.many_group_bytes(m, box) <= kmulti.MAX_BLOCK_SMEM
    assert kmulti.SLOT_MOVERS == kmulti.LANES[-1] * kmulti.SLOTS[-1]
    for m in (1, kmulti.MAX_MOVERS + 1, 4 * kmulti.MAX_MOVERS):
        with pytest.raises(NotImplementedError, match=f'2 to {kmulti.MAX_MOVERS} movers .* bytes of shared memory'):
            kmulti.lane_layout(m, b)


def test_multi_fields_match_cuda_struct():
    """The constants vector's (name, length rule) order is the X-macro order
    of GPRT_MULTI_FIELDS in csrc/planning_multi.cuh, each rule gives the
    C side's length (the GPRT_MULTI_LEN_* macros) for any M, and the two
    sides name the same most movers."""
    src = (PKG / 'csrc' / 'planning_multi.cuh').read_text()
    block = src.split('#define GPRT_MULTI_FIELDS(X)')[1].split('#define')[0]
    assert tuple(re.findall(r'X\((\w+), (\w+)\)', block)) == kmulti.MULTI_FIELDS
    lens = dict(re.findall(r'#define GPRT_MULTI_LEN_(\w+)\(m, pairs\) \(?(\w+)\)?', src))
    assert lens == {'m': 'm', 'pairs': 'pairs', '1': '1'}
    for m in (2, 9, 33, kmulti.MAX_MOVERS):
        names = {'m': m, 'pairs': m * (m - 1) // 2, '1': 1}
        assert [kmulti.field_length(rule, m) for _, rule in kmulti.MULTI_FIELDS] == [
            names[lens[rule]] for _, rule in kmulti.MULTI_FIELDS]
    assert f'kMaxMovers = {kmulti.MAX_MOVERS};' in src
    assert f'kMaxSlotMovers = {kmulti.SLOT_MOVERS};' in src
    # the many-mover variant copies the vector's leading per-mover fields and its last, min_goal_dist
    assert [rule for _, rule in kmulti.MULTI_FIELDS[:9]] == ['m'] * 9 and kmulti.MULTI_FIELDS[-1] == (
        'min_goal_dist', '1')
    enum = re.search(r'enum ManyField \{([^}]*)\}', src).group(1)
    assert len(enum.split(',')) == 9 and 'constexpr int kManyFields = 9;' in src


if __name__ == '__main__':
    # the check above M = 9, too costly for the suite (the Pallas kernel's
    # interpret-mode trace and compile grow with the M(M-1)/2 pairs it
    # unrolls): python tests/test_torch_planning_multi_kernel.py [--movers 65]
    # [--box] [--envs 8] [--cycles 1] [--cand-k 1]; every other env accepts
    # its first start and goal sets, the rest stall
    import argparse
    import json
    import time

    import jax

    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    ap = argparse.ArgumentParser()
    ap.add_argument('--movers', type=int, default=65)
    ap.add_argument('--box', action='store_true')
    ap.add_argument('--envs', type=int, default=8)
    ap.add_argument('--cycles', type=int, default=1)
    ap.add_argument('--cand-k', type=int, default=1)
    cli = ap.parse_args()
    case_name = f'ladder_m{cli.movers}_{"box" if cli.box else "circle"}_full'
    t0 = time.perf_counter()
    out = check_plain_against_pallas(case_name, cli.envs, cli.cand_k, plant=True, plant_k=0, num_cycles=cli.cycles)
    m = cli.movers
    print(json.dumps({'case': case_name, 'envs': cli.envs, 'cycles': cli.cycles, 'cand_k': cli.cand_k,
                      'planes_held': int(out.shape[0]), 'wall_hits': int((out[18 * m + 1] > 0).sum()),
                      'mover_hits': int((out[18 * m + 2] > 0).sum()), 'stalled': int(out[18 * m + 4].sum()),
                      'sets_tested': int(out[18 * m + 5].sum()), 'seconds': time.perf_counter() - t0}))
