"""The box variants of the pushing kernels B, C, C-feat and D against their
plain PyTorch versions, on the card; and the launch seed that stays on the
card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_pushing_box_gpu.py -q

Both noise modes: injected uniforms, and the kernel's own Philox stream
against the plain version fed the host copy of that stream
(``noise.philox_uniforms``).  Tolerances by plane class, as in
``test_torch_kernels_gpu.py`` (nvcc contracts the contact's multiply-adds,
PyTorch does not); the box's noisy pose and rotation round each operation as
the plain version does, so the wall flags must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

TOL = dict(rtol=3e-5, atol=3e-6)
TOL_VEL = dict(rtol=3e-5, atol=1e-4)
TOL_ACC = dict(rtol=1e-4, atol=1e-4)
VEL_PLANES = (10, 11, 13)
ACC_PLANES = (4, 5, 6, 7, 31, 32)
WALL_PLANE = {17: 16, 36: 33}  # the wall flag's plane in kernel B's and kernel C's outputs
B = 4096 + 77  # a masked tail block
BOX = {'shape': 'box', 'size': [0.09, 0.09]}  # the box of the JAX package's bench (bench.py:653-655)
SEED = 7

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def box_env(device, **kw):
    return tpush.make_pushing_env(collision_params=BOX, device=device, **kw)


def episode_state(cfg, prm, b, device, seed=0):
    """init_batch; half the envs planted at the object (contact), a quarter
    near the -x wall moving out (wall hits), every 8th about to truncate."""
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    h, q = b // 2, b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], device=device)
    vel[:h] = torch.tensor([0.4, 0.0], device=device)
    pos[h : h + q, 0] = torch.linspace(0.1, 0.13, q, device=device)
    vel[h : h + q] = torch.tensor([-1.0, 0.2], device=device)
    steps = torch.zeros_like(state.steps)
    steps[::8] = cfg.max_episode_steps - 1
    return dataclasses.replace(state, pos=pos, vel=vel, steps=steps)


def assert_planes_close(got, want):
    for i in range(got.shape[0]):
        if WALL_PLANE.get(got.shape[0]) == i:
            assert torch.equal(got[i], want[i]), f'wall flags differ in {int((got[i] != want[i]).sum())} envs'
            continue
        tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
        torch.testing.assert_close(got[i], want[i], **tol, msg=lambda m, i=i: f'plane {i}: {m}')


def modes(n_noise, b, device):
    """(uniforms for the kernel or None, seed, the plain version's uniforms)
    of the injected and the Philox mode."""
    u = torch.rand((n_noise, b), device=device)
    return (('injected', u, 0, u), ('philox', None, SEED, noise.philox_uniforms(SEED, n_noise, b).to(device)))


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_box_kernel_b_matches_plain(cuda, learn_jerk):
    cfg, prm = box_env(cuda, learn_jerk=learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm)
    assert kc.box
    state = episode_state(cfg, prm, B, cuda)
    act = (torch.rand((2, B), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)
    planes = torch.cat([tpush.state_to_planes(state)[:16], act]).contiguous()
    for mode, u, seed, u_plain in modes(kpush.cycles_noise_planes(cfg.num_cycles, True), B, cuda):
        before = kernels.LAUNCHES['pushing_cycles_box']
        got = kpush.pushing_cycles_cuda(planes, kc, u, seed)
        assert kernels.LAUNCHES['pushing_cycles_box'] == before + 1, mode
        assert_planes_close(got, kpush.pushing_cycles_plain(planes, kc, u_plain))
        assert 0 < int((got[16] > 0).sum()) < B, mode


# C-feat feeds the reactive rollout, which runs in acc mode only
@pytest.mark.parametrize('learn_jerk, emit_features', [(False, False), (True, False), (False, True)])
def test_box_kernel_c_matches_plain(cuda, learn_jerk, emit_features):
    cfg, prm = box_env(cuda, learn_jerk=learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm)
    state = episode_state(cfg, prm, B, cuda)
    act = ((torch.rand((2, B), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)).contiguous()
    st = tpush.state_to_planes(state)
    name = 'pushing_autoreset_features_box' if emit_features else 'pushing_autoreset_box'
    for mode, u, seed, u_plain in modes(kpush.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, True), B, cuda):
        before = kernels.LAUNCHES[name]
        got = kpush.pushing_autoreset_cuda(st, act, kc, u, seed, emit_features)
        assert kernels.LAUNCHES[name] == before + 1, mode
        want = kpush.pushing_autoreset_plain(st, act, kc, u_plain, emit_features)
        if emit_features:
            (got, feat), (want, want_feat) = got, want
            torch.testing.assert_close(feat, want_feat, **TOL_VEL)
            # the blocks are the kernel's own planes, bit for bit
            assert torch.equal(feat, kpush.features_from_planes(st, got))
        assert_planes_close(got, want)
        assert int((got[18] == 0).sum()) >= B // 8 and int((got[33] > 0).sum()) > 0, mode


def test_box_kernel_d_matches_plain(cuda):
    cfg, prm = box_env(cuda)
    kc = kpush.make_kernel_consts(cfg, prm)
    K = 4
    st = tpush.state_to_planes(episode_state(cfg, prm, B, cuda, seed=1))
    acts = ((torch.rand((K, 2, B), device=cuda) * 2 - 1) * 8.0).contiguous()
    for mode, u, seed, u_plain in modes(K * kpush.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, True), B, cuda):
        before = kernels.LAUNCHES['pushing_rollout_box']
        got_st, got_sig = kpush.pushing_rollout_cuda(st, acts, kc, u, seed)
        assert kernels.LAUNCHES['pushing_rollout_box'] == before + 1, mode
        want_st, want_sig = kpush.pushing_rollout_plain(st, acts, kc, u_plain)
        # over K steps a contact event can fall one cycle apart in the two
        # (the boundary is chaotic): the envs whose signals match exactly and
        # whose state agrees at the plane tolerances x10
        env_ok = (got_sig == want_sig).all(0).all(0)
        for i in range(kpush.N_STATE):
            tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
            env_ok &= (got_st[i] - want_st[i]).abs() <= 10 * (tol['atol'] + tol['rtol'] * want_st[i].abs())
        assert float(env_ok.double().mean()) >= 0.995, (mode, float(env_ok.double().mean()))
        assert int((got_sig[0] > 0).sum()) > 0, mode


def test_card_generator_seed_stays_on_the_card(cuda):
    """A seed drawn from a card generator reaches the kernel through device
    memory: the same value by tensor and by int gives the same stream bit for
    bit, and a fused step with a card generator makes no host round trip."""
    cfg, prm = box_env(cuda)
    kc = kpush.make_kernel_consts(cfg, prm, 4)
    state = episode_state(cfg, prm, B, cuda)
    st = tpush.state_to_planes(state)
    act = torch.zeros((2, B), device=cuda)
    seed_t = torch.tensor([SEED], dtype=torch.int64, device=cuda)
    assert torch.equal(kpush.pushing_autoreset_cuda(st, act, kc, None, seed_t),
                       kpush.pushing_autoreset_cuda(st, act, kc, None, SEED))
    pc, pp = tplan.make_planning_env(np.ones((3, 3)), 1, device=cuda)
    pk = kplan.make_kernel_consts(pc, pp)
    pst = tplan.state_to_planes(pc, tplan.init_batch(pc, pp, B, torch.Generator(device=cuda).manual_seed(1))[0])
    pa = torch.ones((2, B), device=cuda)
    assert torch.equal(kplan.planning_autoreset_cuda(pst, pa, pk, None, seed_t),
                       kplan.planning_autoreset_cuda(pst, pa, pk, None, SEED))
    mc_cfg, mc_prm = tplan.make_planning_env(np.ones((4, 4)), 4, device=cuda)
    mc = kmulti.make_multi_kernel_consts(mc_cfg, mc_prm)
    mst = tplan.state_to_planes(mc_cfg, tplan.init_batch(mc_cfg, mc_prm, 512,
                                                          torch.Generator(device=cuda).manual_seed(2))[0])
    ma = torch.ones((8, 512), device=cuda)
    assert torch.equal(kmulti.planning_multi_autoreset_cuda(mst, ma, mc, None, seed_t),
                       kmulti.planning_multi_autoreset_cuda(mst, ma, mc, None, SEED))

    g = torch.Generator(device=cuda).manual_seed(3)
    step = tpush.make_fused_step_autoreset(cfg, prm)
    step(state, act.T, generator=g)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = step(state, act.T, generator=g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[0].pos.shape == (B, 2)
