"""Kernel H above 128 movers (the many-mover variant), on the CPU.

The fused M-mover paths take up to ``planning_multi.MAX_MOVERS`` movers:
``planning.make_fused_step_autoreset`` and ``make_fused_rollout`` at 129
movers run kernel H's plain version here and agree with the eager step at
``std_noise=0`` within the eager-vs-fused tolerances the 4-mover case is
held to (``tests/test_torch_eager_gpu.py``: planning rtol 2e-6 / atol 2e-7,
accelerations rtol 1e-4 / atol 1e-4, wall and mover flags equal), on the
envs that do not restart.  The variant forms each pair's summed sizes from
the float64 per-mover sizes (``MultiConsts.sizes64``): added in float64 and
rounded once, they give the host's per-pair table bit for bit.  The kernel
itself runs on the card only (``tests/test_torch_planning_multi_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import multi_agent
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti

from torch_planning_multi_cases import make_env, planted_state

PLAN = dict(rtol=2e-6, atol=2e-7)
ACC = dict(rtol=1e-4, atol=1e-4)
M = kmulti.SLOT_MOVERS + 1


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eager_vs(fused_state, fused_info, terminated, truncated, eager):
    es, _, _, _, _, ei = eager
    for k in ('wall_collision', 'mover_collision'):
        assert torch.equal(ei[k], fused_info[k]), k
    rows = ~(terminated | truncated)  # the others restarted in the kernel
    for k in ('pos', 'vel'):
        torch.testing.assert_close(getattr(es, k)[rows], getattr(fused_state, k)[rows], **PLAN, msg=k)
    torch.testing.assert_close(es.acc[rows], fused_state.acc[rows], **ACC)
    return rows


@pytest.mark.parametrize('box', [False, True], ids=['circle', 'box'])
def test_fused_step_above_128_movers_matches_eager(box):
    """129 movers on the 22x22 table's grid of slots, 8 envs: two with mover
    0 driven into the -x wall, two with movers 0 and 1 head-on, 8 control
    cycles.  The fused autoreset step (kernel H's plain version) and the
    eager step agree; the multi-agent step keeps the fused step."""
    name = f'ladder_m{M}_{"box" if box else "circle"}_full'
    cfg, prm = make_env(name, std_noise=0.0, num_cycles=8)
    assert multi_agent.fused_covers(cfg, prm) and kmulti.lane_layout(M, 8) == (32, kmulti.SMEM_SLOTS)
    state = planted_state(name, cfg, prm, 8, seed=3)
    state.steps[:] = 0
    act = torch.from_numpy(np.random.default_rng(4).uniform(-8.0, 8.0, (8, M, 2)).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    fs, _, fr, ft, ftr, fi = tplan.make_fused_step_autoreset(cfg, prm)(state, act, generator=g)
    rows = _eager_vs(fs, fi, ft, ftr, tplan.step(cfg, prm, state, act, generator=g))
    assert int(fi['wall_collision'].sum()) >= 1 and int(fi['mover_collision'].sum()) >= 1 and int(rows.sum()) >= 3
    assert set(torch.unique(fr).tolist()) <= {-50.0} | {-float(k) for k in range(M + 1)}


def test_fused_rollout_above_128_movers_matches_eager():
    """``make_fused_rollout`` at 129 movers, one step: its final state is the
    eager step's on the envs that did not restart, its rewards the fused
    step's rule."""
    name = f'ladder_m{M}_circle_full'
    cfg, prm = make_env(name, std_noise=0.0, num_cycles=8)
    state = planted_state(name, cfg, prm, 8, seed=6)
    state.steps[:] = 0
    act = torch.from_numpy(np.random.default_rng(7).uniform(-8.0, 8.0, (1, 8, M, 2)).astype(np.float32))
    fs, rew, term, trunc = tplan.make_fused_rollout(cfg, prm)(state, act, 11)
    es, _, er, et, _, ei = tplan.step(cfg, prm, state, act[0], generator=torch.Generator().manual_seed(0))
    rows = ~(term[0] | trunc[0])
    for k in ('pos', 'vel'):
        torch.testing.assert_close(getattr(es, k)[rows], getattr(fs, k)[rows], **PLAN, msg=k)
    torch.testing.assert_close(es.acc[rows], fs.acc[rows], **ACC)
    assert torch.equal(term[0], ei['wall_collision'] | ei['mover_collision'] | (er == 50.0))
    assert torch.equal(rew[0][term[0]], torch.full_like(rew[0][term[0]], -50.0))
    assert int(rows.sum()) >= 3 and int(term[0].sum()) >= 2


@pytest.mark.parametrize('box', [False, True], ids=['circle', 'box'])
@pytest.mark.parametrize('m', [M, 256])
def test_pair_sums_from_float64_sizes(m, box):
    """Each pair's summed sizes formed as the many-mover variant forms them
    (two float64 per-mover sizes added in float64, rounded once to f32)
    equal the host's per-pair table, for per-mover sizes that differ."""
    rng = np.random.default_rng(m)
    size = rng.uniform(0.08, 0.1, (m, 2) if box else m)
    coll = {'shape': 'box', 'size': size} if box else {'size': size}
    n = int(np.ceil((0.6 + 0.42 * (np.ceil(np.sqrt(m)) - 1)) / 0.24))
    cfg, prm = tplan.make_planning_env(np.ones((n, n)), m, collision_params=coll, device='cpu')
    mc = kmulti.make_multi_kernel_consts(cfg, prm)
    d64 = mc.sizes64.reshape(3, m)
    ii, jj = np.triu_indices(m, 1)  # the pairs in row order
    np.testing.assert_array_equal(np.array(kmulti.pairs(m)), np.stack([ii, jj], 1))
    for row, field in ((0, 'pair_sum'), (1, 'sample_pair_sum_x'), (2, 'sample_pair_sum_y')):
        formed = (d64[row, ii] + d64[row, jj]).astype(np.float32)
        np.testing.assert_array_equal(formed, np.asarray(mc.f[field], np.float32), err_msg=field)
    # the f32 per-mover fields the block copies are the vector's first nine rows, min_goal_dist its last
    np.testing.assert_array_equal(mc.vector[:9 * m].reshape(9, m)[kmulti.MULTI_FIELDS.index(('accel_scale', 'm'))],
                                  np.asarray(mc.f['accel_scale'], np.float32))
    assert mc.vector[-1] == np.float32(mc.f['min_goal_dist'][0])
