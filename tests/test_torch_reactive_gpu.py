"""Kernel C-feat and the reactive rollouts on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX; on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_reactive_gpu.py -q

- C-feat against its plain version, in both noise modes (injected uniforms;
  the kernel's Philox stream against the plain version fed the host copy of
  that stream), acc and jerk.  The emit launch's 36 planes equal kernel C's
  at the same seed bit for bit, and its feature blocks are its own planes'
  rows and differences bit for bit.  Against the plain version the blocks
  agree at kernel C's plane tolerance (rtol 3e-5), with atol 6e-6 (twice
  the planes' 3e-6) for rows that are differences of two planes.
- A constant-policy reactive rollout equals ``make_fused_rollout`` at K=1
  bit for bit (both launch the same kernel with the same seeds).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

from test_torch_kernels_gpu import B, assert_planes_close, episode_state

FEAT_TOL = dict(rtol=3e-5, atol=6e-6)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('learn_jerk', [False, True])
@pytest.mark.parametrize('mode', ['injected', 'philox'])
def test_kernel_c_feat_matches_plain(cuda, learn_jerk, mode):
    cfg, prm = tpush.make_pushing_env(learn_jerk=learn_jerk, device=cuda)
    kc = kpush.make_kernel_consts(cfg, prm)
    state = episode_state(cfg, prm, B, cuda, seed=3)
    act = ((torch.rand((2, B), device=cuda) * 2 - 1) * (80.0 if learn_jerk else 8.0)).contiguous()
    st = tpush.state_to_planes(state)
    n = kpush.autoreset_noise_planes(cfg.num_cycles, kc.cand_k)
    if mode == 'injected':
        u = torch.rand((n, B), device=cuda)
        kw = dict(uniforms=u)
    else:
        u = noise.philox_uniforms(11, n, B).to(cuda)
        kw = dict(seed=11)
    before = dict(kernels.LAUNCHES)
    out, feat = kpush.pushing_autoreset(st, act, kc, emit_features=True, **kw)
    assert kernels.LAUNCHES['pushing_autoreset_features'] == before['pushing_autoreset_features'] + 1
    assert kernels.LAUNCHES['pushing_autoreset'] == before['pushing_autoreset']
    assert feat.shape == (2, kpush.N_FEATURES, B)
    torch.testing.assert_close(out, kpush.pushing_autoreset(st, act, kc, **kw), rtol=0, atol=0)
    torch.testing.assert_close(feat, kpush.features_from_planes(st, out), rtol=0, atol=0)
    want_out, want_feat = kpush.pushing_autoreset_plain(st, act, kc, u, emit_features=True)
    assert_planes_close(out, want_out)
    torch.testing.assert_close(feat, want_feat, **FEAT_TOL)
    assert int((out[18] == 0).sum()) >= B // 8  # restarts fired
    torch.testing.assert_close(feat[1, 6:8], st[16:18], rtol=0, atol=0)


def _constant(action):
    def policy_step(pol, gen, obs_pm):
        return action.expand(2, obs_pm.shape[1]), ()

    return policy_step


@pytest.mark.parametrize('family', ['pushing', 'planning'])
def test_constant_policy_reactive_rollout_matches_fused_rollout(cuda, family):
    b, T = 4096, 16
    g = torch.Generator(device=cuda).manual_seed(4)
    if family == 'pushing':
        mod, key = tpush, 'pushing_autoreset_features'
        cfg, prm = tpush.make_pushing_env(device=cuda)
        state = episode_state(cfg, prm, b, cuda, seed=5)
    else:
        mod, key = tplan, 'planning_autoreset'
        cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, device=cuda)
        state, _, _ = tplan.init_batch(cfg, prm, b, g)
        state.steps[::8] = cfg.max_episode_steps - 2
    action = torch.tensor([[2.0], [-1.0]], device=cuda)
    kernels.reset_launches()
    final_r, traj, last = mod.make_reactive_rollout(cfg, prm, _constant(action), T)(state, None, None, 21)
    assert kernels.LAUNCHES[key] == T
    final_f, rew_f, term_f, trunc_f = mod.make_fused_rollout(cfg, prm)(state, action.T.expand(T, b, 2), 21)
    for f in dataclasses.fields(final_f):
        torch.testing.assert_close(getattr(final_r, f.name), getattr(final_f, f.name), rtol=0, atol=0)
    for got, want in zip(traj[2:5], (rew_f, term_f, trunc_f)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((term_f | trunc_f).any())
