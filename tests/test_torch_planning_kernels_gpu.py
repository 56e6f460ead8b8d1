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

Kernels E, F and G run in two block shapes: with the producer (the consumer
warp and its producer warps, the wrapper's choice up to its configuration's
``planning.WIDE_BATCH`` envs) and thread-per-env (above it); each test of
them runs both, the threshold moved to reach the other (``use_producer``).
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


def use_producer(monkeypatch, producer):
    """Make kernels E, F and G launch blocks with the producer (1) or thread-per-env blocks (0) at every width."""
    wide = 1 << 62 if producer else 0
    monkeypatch.setattr(kplan, 'WIDE_BATCH', {k: dict.fromkeys(v, wide) for k, v in kplan.WIDE_BATCH.items()})


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


@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_kernel_f_matches_plain(cuda, monkeypatch, name, producer):
    use_producer(monkeypatch, producer)
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


@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('name', ['circle_full', 'box_holed'])
def test_kernel_g_matches_plain(cuda, monkeypatch, name, producer):
    use_producer(monkeypatch, producer)
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


@pytest.mark.parametrize('producer', [0, 1])
def test_philox_mode_matches_plain_on_its_stream(cuda, monkeypatch, producer):
    """The in-kernel Philox stream is the host copy's stream, also where
    the thread-per-env kernel passes over the sampling draws of envs that
    are not done and where the producer takes draws by absolute index."""
    from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import philox_uniforms

    use_producer(monkeypatch, producer)
    cfg, prm = make('box_holed', cuda)
    kc = kplan.make_kernel_consts(cfg, prm)
    b = 1024
    st = tplan.state_to_planes(cfg, wall_state(cfg, prm, b, cuda, seed=3))
    act = ((torch.rand((2, b), device=cuda) * 2 - 1) * 10.0).contiguous()
    got = kplan.planning_autoreset(st, act, kc, seed=77)
    u = philox_uniforms(77, kplan.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, kc.box), b).to(cuda)
    assert_planes(got, kplan.planning_autoreset_plain(st, act, kc, u), exact=(8, 19, 20, 21, 22))


@pytest.mark.parametrize('producer', [0, 1])
def test_public_path_k32_matches_k1(cuda, monkeypatch, producer):
    """std_noise = 0: the K=32 rollout (kernel G) and the per-step rollout
    (kernel F) agree on every env that never restarted."""
    use_producer(monkeypatch, producer)
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


# -- kernels F and G at ragged widths ----------------------------------------------
# B = 1, 31, 33 are partial warps (33: a second tile of one env) and 4097 a
# partial tail tile: with the producer every lane takes part in every
# barrier, so none hangs; both noise modes, every configuration, both block
# shapes.
RAGGED = [1, 31, 33, 4097]


def ragged_case(name, b, device, seed, cand_k):
    cfg, prm = make(name, device, learn_jerk=name.endswith('holed'))
    kc = kplan.make_kernel_consts(cfg, prm, cand_k)
    st = tplan.state_to_planes(cfg, wall_state(cfg, prm, b, device, seed=seed))
    return cfg, kc, st


def ragged_modes(n_noise, b, device, seed=7):
    from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import philox_uniforms

    u = torch.rand((n_noise, b), device=device)
    return (('injected', u, 0, u), ('philox', None, seed, philox_uniforms(seed, n_noise, b).to(device)))


@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('name', sorted(CONFIGS))
@pytest.mark.parametrize('b', RAGGED)
def test_kernel_f_matches_plain_at_ragged_widths(cuda, monkeypatch, b, name, producer):
    use_producer(monkeypatch, producer)
    cand_k = 7 if b == 33 else 16  # 33: the goal sampler's first candidate inside a Philox block
    cfg, kc, st = ragged_case(name, b, cuda, b, cand_k)
    act = ((torch.rand((2, b), device=cuda) * 2 - 1) * (100.0 if cfg.learn_jerk else 10.0)).contiguous()
    for mode, u, seed, u_plain in ragged_modes(kplan.autoreset_noise_planes(cfg.num_cycles, cand_k, kc.box), b, cuda):
        got = kplan.planning_autoreset_cuda(st, act, kc, u, seed)
        assert_planes(got, kplan.planning_autoreset_plain(st, act, kc, u_plain), exact=(8, 19, 20, 21, 22))


@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('name', sorted(CONFIGS))
@pytest.mark.parametrize('b', RAGGED)
def test_kernel_g_matches_plain_at_ragged_widths(cuda, monkeypatch, b, name, producer):
    """G over 3 steps; at K=1 one step of G is kernel F's step, bit for bit."""
    use_producer(monkeypatch, producer)
    K, cand_k = 3, 7 if b == 33 else 16
    cfg, kc, st = ragged_case(name, b, cuda, b + 1, cand_k)
    acts = ((torch.rand((K, 2, b), device=cuda) * 2 - 1) * (100.0 if cfg.learn_jerk else 10.0)).contiguous()
    n_step = kplan.autoreset_noise_planes(cfg.num_cycles, cand_k, kc.box)
    for mode, u, seed, u_plain in ragged_modes(K * n_step, b, cuda):
        got_st, got_sig = kplan.planning_rollout_cuda(st, acts, kc, u, seed)
        want_st, want_sig = kplan.planning_rollout_plain(st, acts, kc, u_plain)
        assert torch.equal(got_sig, want_sig), mode
        assert_planes(got_st, want_st, exact=(8,))
        u1 = None if u is None else u[:n_step].contiguous()
        one_st, one_sig = kplan.planning_rollout_cuda(st, acts[:1].contiguous(), kc, u1, seed)
        out = kplan.planning_autoreset_cuda(st, acts[0].contiguous(), kc, u1, seed)
        assert torch.equal(one_st, out[:9]) and torch.equal(one_sig[0, 0], out[19]), mode


@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('name', sorted(CONFIGS))
@pytest.mark.parametrize('b', RAGGED)
def test_kernel_e_matches_plain_at_ragged_widths(cuda, monkeypatch, b, name, producer):
    """Kernel E with the producer (its stages hold whole cycles, the last one
    partial) and thread-per-env, both noise modes."""
    use_producer(monkeypatch, producer)
    cfg, prm = make(name, cuda, learn_jerk=name.startswith('box'))
    kc = kplan.make_kernel_consts(cfg, prm)
    state = wall_state(cfg, prm, b, cuda, seed=b + 2)
    act = (torch.rand((2, b), device=cuda) * 2 - 1) * (100.0 if cfg.learn_jerk else 10.0)
    planes = torch.cat([tplan.state_to_planes(cfg, state)[:6], act]).contiguous()
    for mode, u, seed, u_plain in ragged_modes(kplan.cycles_noise_planes(cfg.num_cycles, kc.box), b, cuda):
        got = kplan.planning_cycles_cuda(planes, kc, u, seed)
        assert_planes(got, kplan.planning_cycles_plain(planes, kc, u_plain), exact=(6,))


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_kernel_e_above_its_wide_batch(cuda, name):
    """The wrapper's own choice above kernel E's wide batch in each
    configuration (thread-per-env blocks), whose last block is partial."""
    cfg, prm = make(name, cuda, learn_jerk=name.startswith('box'))
    kc = kplan.make_kernel_consts(cfg, prm)
    b = kplan.WIDE_BATCH['box' if kc.box else 'circle', 'full' if kc.rule.full else 'holed']['cycles'] + 33
    assert kplan.uses_producer(b, kc, 'cycles') == 0
    state = wall_state(cfg, prm, b, cuda, seed=4)
    act = (torch.rand((2, b), device=cuda) * 2 - 1) * (100.0 if cfg.learn_jerk else 10.0)
    planes = torch.cat([tplan.state_to_planes(cfg, state)[:6], act]).contiguous()
    for mode, u, seed, u_plain in ragged_modes(kplan.cycles_noise_planes(cfg.num_cycles, kc.box), b, cuda):
        got = kplan.planning_cycles_cuda(planes, kc, u, seed)
        assert_planes(got, kplan.planning_cycles_plain(planes, kc, u_plain), exact=(6,))
        assert 0 < int((got[6] > 0).sum()) < b, mode
