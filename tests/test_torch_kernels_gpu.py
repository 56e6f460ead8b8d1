"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX, so it runs on a machine with only PyTorch; the
suite's conftest imports JAX, hence on such a machine:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances, by plane class: positions, goals and observations at rtol
3e-5, atol 3e-6 (nvcc contracts multiply-adds, PyTorch's elementwise ops do
not; contact amplifies a single ulp, the JAX package's cone-share test uses
the same); object velocity and spin (planes 10, 11, 13) at atol 1e-4, as
the Coulomb stick/slip step amplifies ulps there; planes downstream of the
clamp chain's ``(v' - v) / dt`` (acc, act, pre-reset qacc) at rtol 1e-4,
atol 1e-4.  Flags (wall, stalled, trials, signals) match exactly.
"""

import dataclasses

import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

TOL = dict(rtol=3e-5, atol=3e-6)
TOL_VEL = dict(rtol=3e-5, atol=1e-4)
TOL_ACC = dict(rtol=1e-4, atol=1e-4)
VEL_PLANES = (10, 11, 13)
ACC_PLANES = (4, 5, 6, 7, 31, 32)
B = 4096 + 77  # a masked tail block

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def episode_state(cfg, prm, b, device, seed=0):
    """init_batch; half the envs planted at the object (contact), a quarter
    near the -x wall moving out (wall hit), every 8th about to truncate."""
    g = torch.Generator(device=device).manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    h, q = b // 2, b // 4
    pos, vel = state.pos.clone(), state.vel.clone()
    pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], device=device)
    vel[:h] = torch.tensor([0.4, 0.0], device=device)
    pos[h : h + q, 0] = 0.115
    vel[h : h + q] = torch.tensor([-1.0, 0.2], device=device)
    steps = torch.zeros_like(state.steps)
    steps[::8] = cfg.max_episode_steps - 1
    return dataclasses.replace(state, pos=pos, vel=vel, steps=steps)


def assert_planes_close(got, want):
    """Plane-class tolerances (module docstring)."""
    for i in range(got.shape[0]):
        tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
        torch.testing.assert_close(got[i], want[i], **tol, msg=lambda m, i=i: f'plane {i}: {m}')


def test_kernel_a_matches_plain(cuda):
    draws = 8
    u = torch.rand((2 * draws, B), device=cuda)
    before = kernels.LAUNCHES['noise_probe']
    got = noise.noise_probe(draws, B, cuda, uniforms=u)
    assert kernels.LAUNCHES['noise_probe'] == before + 1
    torch.testing.assert_close(got, noise.noise_probe_plain(u), **TOL)
    # the in-kernel Philox stream is the host copy's stream
    got_p = noise.noise_probe(1, B, cuda, seed=99)
    torch.testing.assert_close(got_p, noise.noise_probe_plain(noise.philox_uniforms(99, 2, B).to(cuda)), **TOL)


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_kernel_b_matches_plain(cuda, learn_jerk):
    cfg, prm = tpush.make_pushing_env(learn_jerk=learn_jerk, device=cuda)
    kc = kpush.make_kernel_consts(cfg, prm)
    state = episode_state(cfg, prm, B, cuda)
    act = (torch.rand((2, B), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)
    planes = torch.cat([tpush.state_to_planes(state)[:16], act]).contiguous()
    u = torch.rand((kpush.cycles_noise_planes(cfg.num_cycles), B), device=cuda)
    before = kernels.LAUNCHES['pushing_cycles']
    got = kpush.pushing_cycles(planes, kc, uniforms=u)
    assert kernels.LAUNCHES['pushing_cycles'] == before + 1
    assert_planes_close(got, kpush.pushing_cycles_plain(planes, kc, u))
    assert 0 < int((got[16] > 0).sum()) < B


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_kernel_c_matches_plain(cuda, learn_jerk):
    cfg, prm = tpush.make_pushing_env(learn_jerk=learn_jerk, device=cuda)
    kc = kpush.make_kernel_consts(cfg, prm)
    state = episode_state(cfg, prm, B, cuda)
    act = ((torch.rand((2, B), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)).contiguous()
    st = tpush.state_to_planes(state)
    u = torch.rand((kpush.autoreset_noise_planes(cfg.num_cycles, kc.cand_k), B), device=cuda)
    before = kernels.LAUNCHES['pushing_autoreset']
    got = kpush.pushing_autoreset(st, act, kc, uniforms=u)
    assert kernels.LAUNCHES['pushing_autoreset'] == before + 1
    assert_planes_close(got, kpush.pushing_autoreset_plain(st, act, kc, u))
    assert int((got[18] == 0).sum()) >= B // 8  # restarts fired


def test_kernel_d_matches_plain_over_a_short_chunk(cuda):
    cfg, prm = tpush.make_pushing_env(device=cuda)
    kc = kpush.make_kernel_consts(cfg, prm)
    K = 4
    st = tpush.state_to_planes(episode_state(cfg, prm, B, cuda, seed=1))
    acts = ((torch.rand((K, 2, B), device=cuda) * 2 - 1) * 8.0).contiguous()
    u = torch.rand((K * kpush.autoreset_noise_planes(cfg.num_cycles, kc.cand_k), B), device=cuda)
    before = kernels.LAUNCHES['pushing_rollout']
    got_st, got_sig = kpush.pushing_rollout(st, acts, kc, uniforms=u)
    assert kernels.LAUNCHES['pushing_rollout'] == before + 1
    want_st, want_sig = kpush.pushing_rollout_plain(st, acts, kc, u)
    # over K steps a contact event can fall one cycle apart in the two (the
    # boundary is chaotic): count the envs whose signals match exactly and
    # whose state agrees at the plane tolerances x10
    env_ok = (got_sig == want_sig).all(0).all(0)
    for i in range(kpush.N_STATE):
        tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
        env_ok &= (got_st[i] - want_st[i]).abs() <= 10 * (tol['atol'] + tol['rtol'] * want_st[i].abs())
    assert float(env_ok.double().mean()) >= 0.995, float(env_ok.double().mean())


def test_kernel_wrappers_reject_bad_inputs(cuda):
    cfg, prm = tpush.make_pushing_env(device=cuda)
    kc = kpush.make_kernel_consts(cfg, prm)
    st = torch.zeros((19, 256), device=cuda)
    with pytest.raises(ValueError, match='shape'):
        kpush.pushing_autoreset(st, torch.zeros((3, 256), device=cuda), kc, seed=1)
    with pytest.raises(TypeError, match='float32'):
        kpush.pushing_autoreset(st.double(), torch.zeros((2, 256), device=cuda), kc, seed=1)
    with pytest.raises(ValueError, match='contiguous'):
        kpush.pushing_autoreset(st, torch.zeros((256, 2), device=cuda).T, kc, seed=1)
    with pytest.raises(ValueError, match='must all be on the CPU'):
        kpush.pushing_autoreset(st, torch.zeros((2, 256)), kc, seed=1)


def test_public_path_k32_matches_k1(cuda):
    """std_noise = 0: the K=32 rollout (kernel D) and the per-step rollout
    (kernel C) agree on every env that never restarted."""
    cfg, prm = tpush.make_pushing_env(std_noise=0.0, device=cuda)
    b, T = 4096, 40
    g = torch.Generator(device=cuda).manual_seed(2)
    state, _, _ = tpush.init_batch(cfg, prm, b, g)
    state.pos = state.obj_pos + torch.tensor([-0.115, 0.0], device=cuda)
    state.vel = torch.tensor([0.05, 0.0], device=cuda).expand(b, 2).clone()
    ph = 2 * torch.pi * torch.arange(T, device=cuda) / 20
    acts = torch.stack([3.0 * torch.cos(ph), 0.5 * torch.sin(ph)], -1)[:, None].expand(T, b, 2)
    kernels.reset_launches()
    r1 = tpush.make_fused_rollout(cfg, prm)(state, acts, 5)
    r32 = tpush.make_fused_rollout(cfg, prm, steps_per_launch=32)(state, acts, 5)
    assert kernels.LAUNCHES['pushing_autoreset'] == T and kernels.LAUNCHES['pushing_rollout'] == 2
    live = ~(r1[2].any(0) | r1[3].any(0) | r32[2].any(0) | r32[3].any(0))
    assert live.sum() > b // 2
    for k in ('pos', 'vel', 'obj_pos', 'mover_z'):
        torch.testing.assert_close(getattr(r32[0], k)[live], getattr(r1[0], k)[live], rtol=3e-5, atol=3e-6)


# -- the producer/consumer kernels C and D at ragged widths --------------------------
# B = 1, 31, 33 are partial warps (33: a second tile of one env, with an odd
# cand_k, so a step's draws do not start on a Philox block) and 4097 a
# partial tail tile: every lane takes part in every barrier, so none hangs.
# Each runs both block shapes: with the producer warp (the wrapper's choice
# up to kpush.WIDE_BATCH envs) and without (above it), the threshold moved
# to reach the other.
SPLIT_WIDTHS = [(1, 32), (31, 32), (33, 7), (4097, 32)]


def use_producer(monkeypatch, producer):
    """Make kernels B, C and D launch blocks with (1) or without (0) the producer warp at every width."""
    wide = 1 << 62 if producer else 0
    monkeypatch.setattr(kpush, 'WIDE_BATCH', {k: dict.fromkeys(v, wide) for k, v in kpush.WIDE_BATCH.items()})


def split_modes(n_noise, b, device, seed=7):
    u = torch.rand((n_noise, b), device=device)
    return (('injected', u, 0, u), ('philox', None, seed, noise.philox_uniforms(seed, n_noise, b).to(device)))


SHAPE_KW = {}


def split_env(device, learn_jerk):
    return tpush.make_pushing_env(learn_jerk=learn_jerk, device=device, **SHAPE_KW)


@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('learn_jerk', [False, True])
@pytest.mark.parametrize('b, cand_k', SPLIT_WIDTHS)
def test_split_kernel_c_matches_plain_at_ragged_widths(cuda, monkeypatch, b, cand_k, learn_jerk, producer):
    use_producer(monkeypatch, producer)
    cfg, prm = split_env(cuda, learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm, cand_k)
    st = tpush.state_to_planes(episode_state(cfg, prm, b, cuda, seed=b))
    act = ((torch.rand((2, b), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)).contiguous()
    for mode, u, seed, u_plain in split_modes(kpush.autoreset_noise_planes(cfg.num_cycles, cand_k, kc.box), b, cuda):
        got, feat = kpush.pushing_autoreset_cuda(st, act, kc, u, seed, True)
        # C-feat's 36 planes equal kernel C's, its blocks its own planes
        assert torch.equal(got, kpush.pushing_autoreset_cuda(st, act, kc, u, seed)), mode
        assert torch.equal(feat, kpush.features_from_planes(st, got)), mode
        assert_planes_close(got, kpush.pushing_autoreset_plain(st, act, kc, u_plain))


@pytest.mark.parametrize('K', [1, 3, 32])
@pytest.mark.parametrize('b, cand_k', SPLIT_WIDTHS)
def test_split_kernel_d_matches_plain_at_ragged_widths(cuda, monkeypatch, b, cand_k, K):
    learn_jerk = K == 3
    cfg, prm = split_env(cuda, learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm, cand_k)
    st = tpush.state_to_planes(episode_state(cfg, prm, b, cuda, seed=K))
    acts = ((torch.rand((K, 2, b), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)).contiguous()
    for mode, u, seed, u_plain in split_modes(K * kpush.autoreset_noise_planes(cfg.num_cycles, cand_k, kc.box), b,
                                              cuda):
        want_st, want_sig = kpush.pushing_rollout_plain(st, acts, kc, u_plain)
        for producer in (0, 1):
            use_producer(monkeypatch, producer)
            got_st, got_sig = kpush.pushing_rollout_cuda(st, acts, kc, u, seed)
            # the envs whose signals match exactly and whose state agrees at
            # the plane tolerances x10 (a contact event can fall one cycle apart)
            env_ok = (got_sig == want_sig).all(0).all(0)
            for i in range(kpush.N_STATE):
                tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
                env_ok &= (got_st[i] - want_st[i]).abs() <= 10 * (tol['atol'] + tol['rtol'] * want_st[i].abs())
            assert float(env_ok.double().mean()) >= 0.99, (mode, producer, float(env_ok.double().mean()))
        got_st, got_sig = kpush.pushing_rollout_cuda(st, acts, kc, u, seed)
        if K == 1:
            # one step of D is kernel C's step, bit for bit
            out = kpush.pushing_autoreset_cuda(st, acts[0], kc, u, seed)
            assert torch.equal(got_st, out[:19]) and torch.equal(got_sig[0, 0], out[33]), mode


def assert_planes_close_up_to_wall_latch(got, want, max_frac=1e-3):
    """assert_planes_close on kernel C's 36 planes, with the wall, stalled
    and trials flags equal for every env, except that an env which hit the
    wall in this step (its flag set in both) may latch it one control cycle
    apart -- the noisy wall check's last-ulp rounding, at a wall crossing,
    decides the cycle -- on at most ``max_frac`` of the envs.  Over ~8,000
    envs driven into the wall one such env shows now and then."""
    assert torch.equal(got[33:36], want[33:36])
    ok = torch.ones(got.shape[1], dtype=torch.bool, device=got.device)
    for i in range(got.shape[0]):
        tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
        ok &= (got[i] - want[i]).abs() <= tol['atol'] + tol['rtol'] * want[i].abs()
    assert bool((got[33][~ok] > 0).all()), 'an env that hit no wall disagrees'
    assert int((~ok).sum()) <= max_frac * got.shape[1], int((~ok).sum())


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_split_kernels_above_the_wide_batch(cuda, learn_jerk):
    """The wrapper's own choice above kpush.WIDE_BATCH (blocks without the
    producer), whose last block holds a full tile, a tile of one env and
    two warps past the last env: C, C-feat and D (K=3) against their plain
    versions."""
    b, cand_k, K = kpush.WIDE_BATCH['circle']['autoreset'] + 33, 32, 3
    cfg, prm = split_env(cuda, learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm, cand_k)
    assert kpush.uses_producer(b, kc) == 0 and kpush.uses_producer(b, kc, 'rollout') == 0
    st = tpush.state_to_planes(episode_state(cfg, prm, b, cuda, seed=5))
    acts = ((torch.rand((K, 2, b), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)).contiguous()
    n_step = kpush.autoreset_noise_planes(cfg.num_cycles, cand_k, kc.box)
    for mode, u, seed, u_plain in split_modes(K * n_step, b, cuda):
        u1 = None if u is None else u[:n_step].contiguous()
        got, feat = kpush.pushing_autoreset_cuda(st, acts[0], kc, u1, seed, True)
        assert torch.equal(got, kpush.pushing_autoreset_cuda(st, acts[0], kc, u1, seed)), mode
        assert torch.equal(feat, kpush.features_from_planes(st, got)), mode
        assert_planes_close_up_to_wall_latch(got, kpush.pushing_autoreset_plain(st, acts[0], kc, u_plain[:n_step]))
        got_st, got_sig = kpush.pushing_rollout_cuda(st, acts, kc, u, seed)
        want_st, want_sig = kpush.pushing_rollout_plain(st, acts, kc, u_plain)
        env_ok = (got_sig == want_sig).all(0).all(0)
        for i in range(kpush.N_STATE):
            tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
            env_ok &= (got_st[i] - want_st[i]).abs() <= 10 * (tol['atol'] + tol['rtol'] * want_st[i].abs())
        assert float(env_ok.double().mean()) >= 0.99, (mode, float(env_ok.double().mean()))


# -- kernel B at ragged widths, in both block shapes ----------------------------------
@pytest.mark.parametrize('producer', [0, 1])
@pytest.mark.parametrize('learn_jerk', [False, True])
@pytest.mark.parametrize('b', [1, 31, 33, 4097])
def test_split_kernel_b_matches_plain_at_ragged_widths(cuda, monkeypatch, b, learn_jerk, producer):
    """Kernel B with (1) and without (0) the producer warp, both noise
    modes: its stages hold whole cycles, the last one partial."""
    use_producer(monkeypatch, producer)
    cfg, prm = split_env(cuda, learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm)
    state = episode_state(cfg, prm, b, cuda, seed=b)
    act = (torch.rand((2, b), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)
    planes = torch.cat([tpush.state_to_planes(state)[:16], act]).contiguous()
    for mode, u, seed, u_plain in split_modes(kpush.cycles_noise_planes(cfg.num_cycles, kc.box), b, cuda):
        got = kpush.pushing_cycles_cuda(planes, kc, u, seed)
        assert_planes_close(got, kpush.pushing_cycles_plain(planes, kc, u_plain))


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_split_kernel_b_above_its_wide_batch(cuda, learn_jerk):
    """The wrapper's own choice above kernel B's wide batch (blocks without
    the producer), whose last block holds a full tile, a tile of one env and
    two warps past the last env: the wall flags equal for every env, the
    planes at their class tolerances but on at most 0.1% of the envs, which
    hit the wall in both and latch it one control cycle apart."""
    cfg, prm = split_env(cuda, learn_jerk)
    kc = kpush.make_kernel_consts(cfg, prm)
    b = kpush.WIDE_BATCH['box' if kc.box else 'circle']['cycles'] + 33
    assert kpush.uses_producer(b, kc, 'cycles') == 0
    state = episode_state(cfg, prm, b, cuda, seed=6)
    act = (torch.rand((2, b), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)
    planes = torch.cat([tpush.state_to_planes(state)[:16], act]).contiguous()
    for mode, u, seed, u_plain in split_modes(kpush.cycles_noise_planes(cfg.num_cycles, kc.box), b, cuda):
        got = kpush.pushing_cycles_cuda(planes, kc, u, seed)
        want = kpush.pushing_cycles_plain(planes, kc, u_plain)
        assert torch.equal(got[16], want[16]), mode
        ok = torch.ones(b, dtype=torch.bool, device=cuda)
        for i in range(16):
            tol = TOL_ACC if i in ACC_PLANES else TOL_VEL if i in VEL_PLANES else TOL
            ok &= (got[i] - want[i]).abs() <= tol['atol'] + tol['rtol'] * want[i].abs()
        assert bool((got[16][~ok] > 0).all()), (mode, 'an env that hit no wall disagrees')
        assert int((~ok).sum()) <= 1e-3 * b, (mode, int((~ok).sum()))
