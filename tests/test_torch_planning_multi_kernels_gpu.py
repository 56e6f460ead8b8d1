"""Kernel H (M-mover planning autoreset step) against its plain PyTorch
version, on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_planning_multi_kernels_gpu.py -q

The kernel lays an env over a group of G lanes with L mover slots each
(``planning_multi.lane_layout``).  Checked: M = 2 (box on a layout with a
missing-corner site, acc) and M = 4 (circle on the full 4x4 table, the main
configuration) at a batch with a masked tail block in the wrapper's own
layout; M = 2, 3, 5, 8, 9, 12, 17 and 33, circle and box, on full and holed
tables, at B = 1, 31, 33 and 4097, in every layout kernel H can take for M
(forced through ``LANE_TABLE``); 65, 96 and 128 movers, circle and box, in
L = 4 slots at B = 33 and 4097; the many-mover variant (one warp an env, the
movers in shared memory) at 129, 192 and 256 movers, where the wrapper takes
it, and forced at 2, 9 and 33; the wrapper's layout above ``WIDE_BATCH``;
and the public M-mover paths at 2 to 256 movers.  Both noise modes: injected
uniforms, and the kernel's own Philox stream against the plain version fed
the host copy of that stream (``noise.philox_uniforms``), where the kernel
passes over the sampling draws of envs that are not done.  The kernel
rounds every product and sum on its own, as the plain version's eager ops
do, so flags, steps, unreached counts and trials must match exactly and
every other plane to rtol 1e-6 / atol 1e-7 (in practice bit for bit).
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import philox_uniforms
from torch_planning_multi_cases import LADDER, actions, case, make_env, plant_accepted_sets, planted_state

TOL = dict(rtol=1e-6, atol=1e-7)
B = 4096 + 77  # a masked tail block

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def assert_matches_plain(got, want, m, what=''):
    exact = {8 * m, *range(18 * m + 1, 18 * m + 6)}
    for i in range(got.shape[0]):
        if i in exact:
            assert torch.equal(got[i], want[i]), f'{what} plane {i}: {int((got[i] != want[i]).sum())} envs differ'
        else:
            torch.testing.assert_close(got[i], want[i], **TOL, msg=lambda msg, i=i: f'{what} plane {i}: {msg}')


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('name', ['box_notch_acc_m2', 'circle_full_acc_m4'])
def test_kernel_h_matches_plain(cuda, name, mode):
    cfg, prm = make_env(name, device=cuda)
    m = cfg.num_movers
    mc = kmulti.make_multi_kernel_consts(cfg, prm)
    st = tplan.state_to_planes(cfg, planted_state(name, cfg, prm, B, seed=1))
    act = torch.from_numpy(actions(cfg, B, seed=2).reshape(B, -1).T.copy()).to(cuda)
    n = kmulti.multi_noise_planes(cfg.num_cycles, m, mc.base.cand_k, mc.base.box)
    before = kernels.LAUNCHES['planning_multi_autoreset']
    if mode == 'injected':
        u = torch.rand((n, B), device=cuda)
        got = kmulti.planning_multi_autoreset(st, act, mc, uniforms=u)
    else:
        got = kmulti.planning_multi_autoreset(st, act, mc, seed=77)
        u = philox_uniforms(77, n, B).to(cuda)
    assert kernels.LAUNCHES['planning_multi_autoreset'] == before + 1
    assert_matches_plain(got, kmulti.planning_multi_autoreset_plain(st, act, mc, u), m, name)
    # wall hits, mover collisions and restarts fired
    assert int((got[18 * m + 1] > 0).sum()) > 0 and int((got[18 * m + 2] > 0).sum()) > 0
    assert int(((got[8 * m] == 0) & (st[8 * m] > 0)).sum()) > 0


def ladder_inputs(name, b, cuda, mode, cand_k=8, num_cycles=8):
    """(mc, state planes, action planes, uniforms, seed) of a ladder case at
    ``b`` envs: planted states, half the envs accepting their second start
    and goal sets in the injected mode."""
    cfg, prm = make_env(name, device=cuda, num_cycles=num_cycles, std_noise=[2e-3, 5e-2, 1e-5])
    m = cfg.num_movers
    mc = kmulti.make_multi_kernel_consts(cfg, prm, cand_k)
    st = tplan.state_to_planes(cfg, planted_state(name, cfg, prm, b, seed=3))
    act = torch.from_numpy(actions(cfg, b, seed=4).reshape(b, -1).T.copy()).to(cuda)
    n = kmulti.multi_noise_planes(num_cycles, m, cand_k, mc.base.box)
    if mode == 'philox':
        return mc, st, act, philox_uniforms(91, n, b).to(cuda), 91
    u = torch.rand((n, b), generator=torch.Generator().manual_seed(5)).numpy()
    plant_accepted_sets(u, name, cfg, prm, cand_k, np.arange(0, b, 2))
    return mc, st, act, torch.from_numpy(u).to(cuda), None


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('shape', ['circle', 'box'])
@pytest.mark.parametrize('m', [2, 3, 5, 8, 9, 12, 17, 33])
def test_kernel_h_every_layout(cuda, monkeypatch, m, shape, mode):
    """Every (G, L) kernel H takes for M movers, forced through the
    wrapper's table, at ragged widths: one env, one short of a warp, one
    over, and a tail block; holed tables at M = 2, 5, 9, 17, full at the
    others."""
    name = f'ladder_m{m}_{shape}_{"holed" if m in (2, 5, 9, 17) else "full"}'
    assert name in LADDER
    for b in (1, 31, 33, 4097):
        mc, st, act, u, seed = ladder_inputs(name, b, cuda, mode)
        want = kmulti.planning_multi_autoreset_plain(st, act, mc, u)
        for layout in kmulti.layouts(m):
            monkeypatch.setitem(kmulti.LANE_TABLE, kmulti.table_row(m), (layout, layout))
            assert kmulti.lane_layout(m, b) == layout
            got = kmulti.planning_multi_autoreset_cuda(st, act, mc, u if seed is None else None, seed or 0)
            assert_matches_plain(got, want, m, f'{name} B={b} (G, L)={layout}')
        if b == 4097:
            # wall hits, mover collisions and the done envs' restarts or stalls fired
            assert int((want[18 * m + 1] > 0).sum()) > 0 and int((want[18 * m + 2] > 0).sum()) > 0
            assert int((want[18 * m + 5] > 0).sum()) > 0


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('shape', ['circle', 'box'])
@pytest.mark.parametrize('m', [65, 96, 128])
def test_kernel_h_above_64_movers(cuda, m, shape, mode):
    """65 to 128 movers take 32 lanes of 4 slots (the only layout there),
    on the full table of their ladder case, at one env over a warp and a
    tail block, at the depth ``chip_smoke.py`` times: 40 cycles and 16
    candidate sets (in the injected mode half the envs accept their second
    sets, so restarts fire)."""
    name = f'ladder_m{m}_{shape}_full'
    assert kmulti.layouts(m) == ((32, 4),)
    for b in (33, 4097):
        assert kmulti.lane_layout(m, b) == (32, 4)
        mc, st, act, u, seed = ladder_inputs(name, b, cuda, mode, cand_k=16, num_cycles=40)
        got = kmulti.planning_multi_autoreset(st, act, mc, uniforms=u if seed is None else None, seed=seed)
        want = kmulti.planning_multi_autoreset_plain(st, act, mc, u)
        assert_matches_plain(got, want, m, f'{name} B={b}')
        if b == 4097:
            assert int((want[18 * m + 1] > 0).sum()) > 0 and int((want[18 * m + 2] > 0).sum()) > 0
            assert int((want[18 * m + 5] > 0).sum()) > 0
            if mode == 'injected':
                assert int(((want[8 * m] == 0) & (st[8 * m] > 0)).sum()) > 0  # restarts accepted


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('shape', ['circle', 'box'])
@pytest.mark.parametrize('m', [129, 192, 256])
def test_kernel_h_above_128_movers(cuda, m, shape, mode):
    """Above 128 movers the wrapper takes the many-mover variant (its launch
    counted under ``planning_multi_autoreset_many``), at one env a warp with
    a tail block, at the depth of the 65-128 test: 40 cycles and 16
    candidate sets."""
    name = f'ladder_m{m}_{shape}_full'
    assert kmulti.layouts(m) == ((32, kmulti.SMEM_SLOTS),)
    for b in (33, 4097):
        assert kmulti.lane_layout(m, b) == (32, kmulti.SMEM_SLOTS)
        mc, st, act, u, seed = ladder_inputs(name, b, cuda, mode, cand_k=16, num_cycles=40)
        before = dict(kernels.LAUNCHES)
        got = kmulti.planning_multi_autoreset(st, act, mc, uniforms=u if seed is None else None, seed=seed)
        assert kernels.LAUNCHES['planning_multi_autoreset_many'] == before['planning_multi_autoreset_many'] + 1
        assert kernels.LAUNCHES['planning_multi_autoreset'] == before['planning_multi_autoreset']
        want = kmulti.planning_multi_autoreset_plain(st, act, mc, u)
        assert_matches_plain(got, want, m, f'{name} B={b}')
        if b == 4097:
            assert int((want[18 * m + 1] > 0).sum()) > 0 and int((want[18 * m + 2] > 0).sum()) > 0
            assert int((want[18 * m + 5] > 0).sum()) > 0
            if mode == 'injected':
                assert int(((want[8 * m] == 0) & (st[8 * m] > 0)).sum()) > 0  # restarts accepted


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('shape', ['circle', 'box'])
@pytest.mark.parametrize('m', [2, 9, 33])
def test_many_mover_variant_forced_below(cuda, monkeypatch, m, shape, mode):
    """The many-mover variant runs any M: forced at 2, 9 and 33 movers
    (fewer pairs than lanes at 2 and 9), at ragged widths."""
    name = f'ladder_m{m}_{shape}_{"holed" if m == 9 else "full"}'
    layout = (32, kmulti.SMEM_SLOTS)
    monkeypatch.setitem(kmulti.LANE_TABLE, kmulti.table_row(m), (layout, layout))
    for b in (1, 33, 4097):
        mc, st, act, u, seed = ladder_inputs(name, b, cuda, mode)
        got = kmulti.planning_multi_autoreset_cuda(st, act, mc, u if seed is None else None, seed or 0)
        assert_matches_plain(got, kmulti.planning_multi_autoreset_plain(st, act, mc, u), m, f'{name} B={b}')


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('m', [4, 12])
def test_kernel_h_above_the_wide_batch(cuda, m, mode):
    """The wrapper's own layout above ``WIDE_BATCH`` envs."""
    name = f'ladder_m{m}_circle_full'
    b = kmulti.WIDE_BATCH + 77
    assert kmulti.lane_layout(m, b) == kmulti.LANE_TABLE[kmulti.table_row(m)][1]
    mc, st, act, u, seed = ladder_inputs(name, b, cuda, mode)
    got = kmulti.planning_multi_autoreset(st, act, mc, uniforms=u if seed is None else None, seed=seed)
    assert_matches_plain(got, kmulti.planning_multi_autoreset_plain(st, act, mc, u), m, name)


@pytest.mark.parametrize('m', [2, 4, 9, 12, 33, 65, 128, 129, 256])
def test_public_paths_run_kernel_h(cuda, m):
    """make_fused_step_autoreset, make_fused_rollout and the multi-agent
    step at M movers launch kernel H once a step (above 128 movers its
    many-mover variant), with no eager fallback; more than ``MAX_MOVERS``
    movers raise, naming the limit."""
    from gymnasium_planar_robotics_tpu_torch.models import multi_agent

    side = {2: 3, 4: 4, 9: 6, 12: 8, 33: 16, 65: 17, 128: 22, 129: 22, 256: 29}[m]
    if m == 256:
        over = kmulti.MAX_MOVERS + 1
        cfg_over, prm_over = tplan.make_planning_env(np.ones((24, 24)), over, device=cuda)
        assert not multi_agent.fused_covers(cfg_over, prm_over)
        with pytest.raises(NotImplementedError, match=f'2 to {kmulti.MAX_MOVERS} movers'):
            tplan.make_fused_step_autoreset(cfg_over, prm_over)
    cfg, prm = tplan.make_planning_env(np.ones((side, side)), m, num_cycles=8, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    b = 257
    if m <= 33:
        state = tplan.init_batch(cfg, prm, b, g)[0]
    else:
        # random sets of this many movers are never apart (and init_batch's
        # candidate sets would not fit the card): the ladder's slots
        slots = case(f'ladder_m{m}_circle_full')[4]
        state = tplan.reset(cfg, prm, b, g, start_xy=slots, goals_xy=slots[::-1])[0]
    assert multi_agent.fused_covers(cfg, prm)
    counter = kmulti.launch_name(kmulti.lane_layout(m, b)[1])
    before = kernels.LAUNCHES[counter]
    step = tplan.make_fused_step_autoreset(cfg, prm)
    s = step(state, torch.zeros((b, m, 2), device=cuda), generator=g)[0]
    par = multi_agent.make_batched_parallel_step(cfg, prm)
    assert par.noise_planes == step.noise_planes
    s, batch = par(s, torch.zeros((b, m, 2), device=cuda), generator=g)
    assert batch.reward.shape == (b, m)
    fs, rew, term, trunc = tplan.make_fused_rollout(cfg, prm)(s, torch.zeros((3, b, m, 2), device=cuda), 7)
    assert kernels.LAUNCHES[counter] == before + 1 + 1 + 3
    assert fs.pos.shape == (b, m, 2) and bool(torch.isfinite(fs.pos).all()) and rew.shape == (3, b)
