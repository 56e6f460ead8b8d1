"""The planning kernels E, F and G against their plain PyTorch versions, on
the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_planning_kernels_gpu.py -q

Four configurations: circle and box collision shapes, each on the full 3x3
table and on a holed layout (box: an L-shape with two missing diagonal
corners, so the missing-corner rectangle tests run).  The kernels round
every product and sum on their own and divide by IEEE division, as the
plain versions' eager ops do, so flags and steps must match exactly and
every other plane to rtol 1e-6 / atol 1e-7 (in practice bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan

TOL = dict(rtol=1e-6, atol=1e-7)
B = 4096 + 77  # a masked tail block
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
CONFIGS = {
    'circle_full': (np.ones((3, 3)), {}),
    'circle_holed': (np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]]), {}),
    'box_full': (np.ones((3, 3)), BOX),
    'box_holed': (np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]]), BOX),
}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def make(name, device, **kw):
    layout, coll = CONFIGS[name]
    return tplan.make_planning_env(layout, 1, collision_params=coll, device=device, **kw)


def wall_state(cfg, prm, b, device, seed=0):
    """init_batch; a quarter of the envs just inside the +x edge moving out
    at 1 m/s (wall hits, restarts), every 8th about to truncate."""
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = tplan.init_batch(cfg, prm, b, g)
    q = b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:q, 0, 0] = 0.58
    vel[:q, 0] = torch.tensor([1.0, 0.1], device=device)
    steps = torch.zeros_like(state.steps)
    steps[::8] = cfg.max_episode_steps - 1
    return dataclasses.replace(state, pos=pos, vel=vel, steps=steps)


def far_goals(state):
    """Goals in the sampling box's corner farthest from each start, so that
    a small oscillating drive never reaches them."""
    far = torch.where(state.pos < 0.36, 0.6, 0.12)
    return dataclasses.replace(state, goals=far.to(state.pos.dtype))


def assert_planes(got, want, exact=()):
    for i in range(got.shape[0]):
        if i in exact:
            assert torch.equal(got[i], want[i]), f'plane {i}: {int((got[i] != want[i]).sum())} envs differ'
        else:
            torch.testing.assert_close(got[i], want[i], **TOL, msg=lambda m, i=i: f'plane {i}: {m}')


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_kernel_e_matches_plain(cuda, name):
    cfg, prm = make(name, cuda, learn_jerk=name.startswith('box'))
    kc = kplan.make_kernel_consts(cfg, prm)
    state = wall_state(cfg, prm, B, cuda)
    lim = 100.0 if cfg.learn_jerk else 10.0
    act = (torch.rand((2, B), device=cuda) * 2 - 1) * lim
    planes = torch.cat([tplan.state_to_planes(cfg, state)[:6], act]).contiguous()
    u = torch.rand((kplan.cycles_noise_planes(cfg.num_cycles, kc.box), B), device=cuda)
    before = kernels.LAUNCHES['planning_cycles']
    got = kplan.planning_cycles(planes, kc, uniforms=u)
    assert kernels.LAUNCHES['planning_cycles'] == before + 1
    assert_planes(got, kplan.planning_cycles_plain(planes, kc, u), exact=(6,))
    assert 0 < int((got[6] > 0).sum()) < B


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_kernel_f_matches_plain(cuda, name):
    cfg, prm = make(name, cuda, learn_jerk=name.endswith('holed'))
    kc = kplan.make_kernel_consts(cfg, prm)
    state = wall_state(cfg, prm, B, cuda, seed=1)
    act = ((torch.rand((2, B), device=cuda) * 2 - 1) * (100.0 if cfg.learn_jerk else 10.0)).contiguous()
    st = tplan.state_to_planes(cfg, state)
    u = torch.rand((kplan.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, kc.box), B), device=cuda)
    before = kernels.LAUNCHES['planning_autoreset']
    got = kplan.planning_autoreset(st, act, kc, uniforms=u)
    assert kernels.LAUNCHES['planning_autoreset'] == before + 1
    assert_planes(got, kplan.planning_autoreset_plain(st, act, kc, u), exact=(8, 19, 20, 21, 22))
    assert int((got[8] == 0).sum()) >= B // 8 and int((got[19] > 0).sum()) > 0  # restarts and wall hits


@pytest.mark.parametrize('name', ['circle_full', 'box_holed'])
def test_kernel_g_matches_plain(cuda, name):
    cfg, prm = make(name, cuda)
    kc = kplan.make_kernel_consts(cfg, prm)
    K = 4
    st = tplan.state_to_planes(cfg, wall_state(cfg, prm, B, cuda, seed=2))
    acts = ((torch.rand((K, 2, B), device=cuda) * 2 - 1) * 10.0).contiguous()
    u = torch.rand((K * kplan.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, kc.box), B), device=cuda)
    before = kernels.LAUNCHES['planning_rollout']
    got_st, got_sig = kplan.planning_rollout(st, acts, kc, uniforms=u)
    assert kernels.LAUNCHES['planning_rollout'] == before + 1
    want_st, want_sig = kplan.planning_rollout_plain(st, acts, kc, u)
    assert torch.equal(got_sig, want_sig)
    assert_planes(got_st, want_st, exact=(8,))


def test_philox_mode_matches_plain_on_its_stream(cuda):
    """The in-kernel Philox stream is the host copy's stream, also where
    the autoreset kernel passes over the sampling draws of envs that are
    not done."""
    from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import philox_uniforms

    cfg, prm = make('box_holed', cuda)
    kc = kplan.make_kernel_consts(cfg, prm)
    b = 1024
    st = tplan.state_to_planes(cfg, wall_state(cfg, prm, b, cuda, seed=3))
    act = ((torch.rand((2, b), device=cuda) * 2 - 1) * 10.0).contiguous()
    got = kplan.planning_autoreset(st, act, kc, seed=77)
    u = philox_uniforms(77, kplan.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, kc.box), b).to(cuda)
    assert_planes(got, kplan.planning_autoreset_plain(st, act, kc, u), exact=(8, 19, 20, 21, 22))


def test_public_path_k32_matches_k1(cuda):
    """std_noise = 0: the K=32 rollout (kernel G) and the per-step rollout
    (kernel F) agree on every env that never restarted."""
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, std_noise=0.0, device=cuda)
    b, T = 4096, 40
    g = torch.Generator(device=cuda).manual_seed(2)
    state = far_goals(tplan.init_batch(cfg, prm, b, g)[0])
    ph = 2 * torch.pi * torch.arange(T, device=cuda) / 20
    acts = torch.stack([2.0 * torch.cos(ph), -2.0 * torch.cos(ph)], -1)[:, None].expand(T, b, 2)
    kernels.reset_launches()
    r1 = tplan.make_fused_rollout(cfg, prm)(state, acts, 5)
    r32 = tplan.make_fused_rollout(cfg, prm, steps_per_launch=32)(state, acts, 5)
    assert kernels.LAUNCHES['planning_autoreset'] == T and kernels.LAUNCHES['planning_rollout'] == 2
    live = ~(r1[2].any(0) | r1[3].any(0) | r32[2].any(0) | r32[3].any(0))
    assert live.sum() > b // 4
    for k in ('pos', 'vel', 'acc', 'goals'):
        assert torch.equal(getattr(r32[0], k)[live], getattr(r1[0], k)[live]), k
