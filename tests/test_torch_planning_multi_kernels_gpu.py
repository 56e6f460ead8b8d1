"""Kernel H (M-mover planning autoreset step) against its plain PyTorch
version, on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_planning_multi_kernels_gpu.py -q

M = 2 (box on a layout with a missing-corner site, acc) and M = 4 (circle
on the full 4x4 table, the main configuration), at a batch with a masked
tail block, in both noise modes: injected uniforms, and the kernel's own
Philox stream against the plain version fed the host copy of that stream
(``noise.philox_uniforms``), where the kernel passes over the sampling
draws of envs that are not done.  The kernel rounds every product and sum
on its own, as the plain version's eager ops do, so flags, steps, unreached
counts and trials must match exactly and every other plane to rtol 1e-6 /
atol 1e-7 (in practice bit for bit).
"""

import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import philox_uniforms
from torch_planning_multi_cases import actions, make_env, planted_state

TOL = dict(rtol=1e-6, atol=1e-7)
B = 4096 + 77  # a masked tail block

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


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
    want = kmulti.planning_multi_autoreset_plain(st, act, mc, u)
    exact = {8 * m, *range(18 * m + 1, 18 * m + 6)}
    for i in range(got.shape[0]):
        if i in exact:
            assert torch.equal(got[i], want[i]), f'plane {i}: {int((got[i] != want[i]).sum())} envs differ'
        else:
            torch.testing.assert_close(got[i], want[i], **TOL, msg=lambda msg, i=i: f'plane {i}: {msg}')
    # wall hits, mover collisions and restarts fired
    assert int((got[18 * m + 1] > 0).sum()) > 0 and int((got[18 * m + 2] > 0).sum()) > 0
    assert int(((got[8 * m] == 0) & (st[8 * m] > 0)).sum()) > 0


def test_out_of_range_movers_raise(cuda):
    cfg, prm = tplan.make_planning_env(torch.ones((6, 6)).numpy(), 9, device=cuda)
    with pytest.raises(NotImplementedError, match='2 to 8 movers'):
        kmulti.make_multi_kernel_consts(cfg, prm)
