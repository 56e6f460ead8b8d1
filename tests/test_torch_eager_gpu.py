"""The eager steps against the fused kernels, on the card.

At ``std_noise = 0`` the eager ``step`` (torch ops over 40 control cycles)
and the fused kernels compute the same step: pushing against kernel B
(``make_fused_step``), 1-mover planning against kernel E, 4-mover planning
against kernel H (``make_fused_step_autoreset``, envs that do not restart).
Every test needs a CUDA device (``gpu`` marker); the module imports no JAX:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_eager_gpu.py -q

Tolerances, the JAX package's eager-vs-fused ones (``tests/test_pallas_step.py``):
pushing as its straight-push test (the scenario here) for the fields it
checks, pos, vel, obj_pos and obj_vel rtol 2e-6 / atol 2e-6 and acc rtol
1e-4 / atol 1e-5; obj_yaw as its diagonal test, rtol 1e-4 / atol 1e-6;
mover_z, obj_w and mover_vz, which neither checks, as its cone-share test's
positions (rtol 3e-5 / atol 3e-6) and velocities (rtol 3e-5 / atol 1e-4:
contact amplifies an ulp); the commanded ``act`` as acc.  Planning rtol
2e-6 / atol 2e-7 (its accel-scale test), accelerations rtol 1e-4 / atol
1e-4 (``(v' - v) / dt`` scales an ulp of |v| = 2 by 1000); wall and mover
flags equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu

B = 4096 + 77  # a masked tail block
PUSH = {('pos', 'vel', 'obj_pos', 'obj_vel'): dict(rtol=2e-6, atol=2e-6),
        ('acc', 'act'): dict(rtol=1e-4, atol=1e-5),
        ('obj_yaw',): dict(rtol=1e-4, atol=1e-6),
        ('mover_z',): dict(rtol=3e-5, atol=3e-6),
        ('obj_w', 'mover_vz'): dict(rtol=3e-5, atol=1e-4)}
ACC = dict(rtol=1e-4, atol=1e-4)
PLAN = dict(rtol=2e-6, atol=2e-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('jerk', [False, True], ids=['acc', 'jerk'])
def test_pushing_eager_step_matches_kernel_b(cuda, jerk):
    cfg, prm = tpush.make_pushing_env(std_noise=0.0, learn_jerk=jerk, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    state, _, _ = tpush.init_batch(cfg, prm, B, g)
    h, q = B // 2, B // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], device=cuda)
    vel[:h] = torch.tensor([0.4, 0.0], device=cuda)
    pos[h:h + q, 0] = 0.115
    vel[h:h + q] = torch.tensor([-1.0, 0.2], device=cuda)
    state = dataclasses.replace(state, pos=pos, vel=vel)
    act = (torch.rand((B, 2), generator=g, device=cuda) * 2 - 1) * (80.0 if jerk else 8.0)
    before = dict(kernels.LAUNCHES)
    es, _, er, et, _, ei = tpush.step(cfg, prm, state, act, generator=g)
    fs, _, fr, ft, _, fi = tpush.make_fused_step(cfg, prm)(state, act, seed=7, generator=g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['pushing_cycles'] == before['pushing_cycles'] + 1
    for keys, tol in PUSH.items():
        for k in keys:
            torch.testing.assert_close(getattr(es, k), getattr(fs, k), **tol, msg=lambda m, k=k: f'{k}: {m}')
    assert torch.equal(ei['wall_collision'], fi['wall_collision']) and torch.equal(et, ft)
    wall = int(ei['wall_collision'].sum())
    assert 0 < wall < B and bool(((es.obj_pos - state.obj_pos).abs() > 1e-5).any())


@pytest.mark.parametrize('movers', [1, 4])
def test_planning_eager_step_matches_kernels_e_and_h(cuda, movers):
    layout = np.ones((3, 3)) if movers == 1 else np.ones((4, 4))
    cfg, prm = tplan.make_planning_env(layout, movers, std_noise=0.0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    state, _, _ = tplan.init_batch(cfg, prm, B, g)
    q = B // 4
    state.pos[:q, 0, 0] = torch.linspace(0.10, 0.13, q, device=cuda)
    state.vel[:q, 0] = torch.tensor([-1.0, 0.1], device=cuda)
    if movers > 1:
        state.pos[q:2 * q, 1] = state.pos[q:2 * q, 0] + torch.tensor([0.221, 0.0], device=cuda)
        state.vel[q:2 * q, 0] = torch.tensor([1.0, 0.0], device=cuda)
        state.vel[q:2 * q, 1] = torch.tensor([-1.0, 0.0], device=cuda)
    act = (torch.rand((B, movers, 2), generator=g, device=cuda) * 2 - 1) * 8.0
    es, _, er, et, _, ei = tplan.step(cfg, prm, state, act, generator=g)
    if movers == 1:
        fs, _, fr, ft, _, fi = tplan.make_fused_step(cfg, prm)(state, act, seed=7, generator=g)
        rows = torch.ones(B, dtype=torch.bool, device=cuda)
    else:
        fs, _, fr, ft, ftr, fi = tplan.make_fused_step_autoreset(cfg, prm)(state, act, seed=7, generator=g)
        rows = ~(ft | ftr)  # kernel H restarted the others
    torch.cuda.synchronize()
    for k in ('wall_collision', 'mover_collision'):
        assert torch.equal(ei[k], fi[k]), k
    for k in ('pos', 'vel'):
        torch.testing.assert_close(getattr(es, k)[rows], getattr(fs, k)[rows], **PLAN, msg=k)
    torch.testing.assert_close(es.acc[rows], fs.acc[rows], **ACC)
    assert 0 < int(ei['wall_collision'].sum()) < B and int(rows.sum()) > B // 4
    if movers > 1:
        assert 0 < int(ei['mover_collision'].sum()) < B
