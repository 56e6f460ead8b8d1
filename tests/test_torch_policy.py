"""Kernel P's wrapper (``ops/kernels/policy``) and ``ppo.sample_action_pm``
on the CPU: the plain path is today's torch ops bit for bit, the wrapper's
contract raises on what the kernel does not take, the env tile follows the
widest layer, and the card's path takes the kernel or raises under
autograd.  The kernel itself is
held against the plain version on the card (``test_torch_policy_gpu.py``).
"""

import math

import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import ppo
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import policy as kpolicy

SCALE = 10.0


def make_policy(obs_dim=12, hidden=(32, 24), action_dim=2, seed=0):
    pol = ppo.init_params(ppo.PPOConfig(obs_dim=obs_dim, action_dim=action_dim, hidden=hidden),
                          torch.Generator().manual_seed(seed), device='cpu')
    with torch.no_grad():
        for p in (*(layer.bias for layer in pol.trunk), pol.mu.bias, pol.value.bias):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed + 1)) * 0.1)
        pol.mu.weight.mul_(30.0)
        pol.log_std.copy_(torch.linspace(-0.5, 0.3, action_dim))
    return pol


def forward_pm_ops(policy, obs_pm):
    """``forward_pm`` as its torch ops stood before kernel P."""
    x = obs_pm
    for layer in policy.trunk:
        x = torch.tanh(torch.addmm(layer.bias[:, None], layer.weight, x))
    mu = torch.addmm(policy.mu.bias[:, None], policy.mu.weight, x)
    value = torch.addmm(policy.value.bias[:, None], policy.value.weight, x)[0]
    return mu, policy.log_std, value


def sample_pm_ops(policy, obs_pm, eps, scale):
    """``sample_action_pm`` as its torch ops stood before kernel P."""
    mu, log_std, value = forward_pm_ops(policy, obs_pm)
    std = torch.exp(log_std)[:, None]
    raw = mu + std * eps
    logp = (-0.5 * ((raw - mu) / std) ** 2 - log_std[:, None] - 0.5 * math.log(2 * math.pi)).sum(0)
    return torch.clamp(raw, -scale, scale), raw, logp, value


@pytest.mark.parametrize('hidden', [(32, 24), (256, 256), (16,), (8, 12, 10)])
@pytest.mark.parametrize('grad', [False, True])
def test_cpu_path_is_bit_equal_to_the_torch_ops(hidden, grad):
    pol = make_policy(hidden=hidden)
    x = torch.randn((12, 37), generator=torch.Generator().manual_seed(3))
    eps = torch.randn((2, 37), generator=torch.Generator().manual_seed(4))
    with torch.set_grad_enabled(grad):
        given = ppo.sample_action_pm(pol, x, eps, SCALE)
        drawn = ppo.sample_action_pm(pol, x, torch.Generator().manual_seed(4), SCALE)
        want = sample_pm_ops(pol, x, eps, SCALE)
    for g, d, w in zip(given, drawn, want):
        assert torch.equal(g, w) and torch.equal(d, w)
        assert (g.grad_fn is not None) == grad


def test_forward_pm_is_the_torch_ops():
    pol = make_policy(hidden=(20, 16))
    x = torch.randn((12, 9), generator=torch.Generator().manual_seed(5))
    for got, want in zip(ppo.apply_pm(pol, x), forward_pm_ops(pol, x)):
        assert torch.equal(got, want)


@pytest.mark.parametrize('widest,tile', [(6, 64), (12, 64), (64, 64), (256, 64), (257, 32), (512, 32), (513, 16),
                                         (1024, 16)])
def test_env_tile_follows_the_widest_layer(widest, tile):
    assert kpolicy.env_tile(widest) == tile
    # a block carries its tile through a [widest, tile] f32 activation tile of at most 64 KB
    assert widest * tile * 4 <= 64 * 1024


@pytest.mark.parametrize('obs_dim,hidden,batch,tile,blocks', [
    (12, (256, 256), 65536, 64, 1024), (12, (256, 256), 4097, 64, 65), (6, (64, 64), 4096, 64, 64),
    (64, (512, 512), 4096, 32, 128), (12, (1024,), 1000, 16, 63), (300, (8,), 5, 32, 1),
])
def test_kernel_args_tile_and_grid(obs_dim, hidden, batch, tile, blocks):
    pol = make_policy(obs_dim=obs_dim, hidden=hidden)
    x, eps = torch.zeros((obs_dim, batch)), torch.zeros((2, batch))
    tensors, dims, got = kpolicy.kernel_args(x, eps, *pol.params_pm())
    assert dims == [obs_dim, *hidden] and got == tile and -(-batch // got) == blocks
    # the C interface's order: x, eps, then each layer's weight and bias, the heads, log_std
    trunk, mu, value, log_std = pol.params_pm()
    want = [x, eps, *(t for pair in trunk for t in pair), *mu, *value, log_std]
    assert len(tensors) == len(want) and all(a is b for a, b in zip(tensors, want))


def _args(pol, batch=16):
    trunk, mu, value, log_std = pol.params_pm()
    return [torch.zeros((12, batch)), torch.zeros((2, batch)), trunk, mu, value, log_std]


@pytest.mark.parametrize('case,error,match', [
    ('x_dtype', TypeError, 'x must be float32'),
    ('eps_shape', ValueError, r'eps must have shape \(2, 16\)'),
    ('x_strided', ValueError, 'x must be contiguous'),
    ('weight_strided', ValueError, r'trunk\[1\].weight must be contiguous'),
    ('bias_dtype', TypeError, r'trunk\[0\].bias must be float32'),
    ('device', ValueError, 'mu.weight lies on meta'),
    ('x_1d', ValueError, r'x must be \[features, batch\]'),
    ('empty_batch', ValueError, 'at least one'),
    ('wide', ValueError, 'layers up to 1024 wide, got 1025'),
    ('deep', ValueError, '1 to 8 trunk layers, got 9'),
    ('actions', ValueError, '1 to 7 actions'),
])
def test_kernel_args_raise(case, error, match):
    pol = make_policy(hidden=(32, 24))
    x, eps, trunk, mu, value, log_std = _args(pol)
    if case == 'x_dtype':
        x = x.double()
    elif case == 'eps_shape':
        eps = torch.zeros((2, 15))
    elif case == 'x_strided':
        x = torch.zeros((16, 12)).T
    elif case == 'weight_strided':
        trunk[1] = (torch.zeros((32, 24)).T, trunk[1][1])
    elif case == 'bias_dtype':
        trunk[0] = (trunk[0][0], trunk[0][1].double())
    elif case == 'device':
        mu = (torch.zeros((2, 24), device='meta'), mu[1])
    elif case == 'x_1d':
        x = torch.zeros(16)
    elif case == 'empty_batch':
        x, eps = torch.zeros((12, 0)), torch.zeros((2, 0))
    elif case == 'wide':
        pol = make_policy(hidden=(1025,))
        trunk, mu, value, log_std = pol.params_pm()
    elif case == 'deep':
        pol = make_policy(hidden=(4,) * 9)
        trunk, mu, value, log_std = pol.params_pm()
    elif case == 'actions':
        pol = make_policy(hidden=(8,), action_dim=8)
        trunk, mu, value, log_std = pol.params_pm()
        eps = torch.zeros((8, 16))
    with pytest.raises(error, match=match):
        kpolicy.kernel_args(x, eps, trunk, mu, value, log_std)


def test_cuda_launcher_refuses_cpu_tensors():
    pol = make_policy()
    with torch.no_grad(), pytest.raises(ValueError, match='needs CUDA tensors'):
        kpolicy.policy_mlp_cuda(*_args(pol), SCALE)


@pytest.mark.parametrize('grad', [False, True])
def test_card_path_takes_the_kernel_or_raises_under_autograd(monkeypatch, grad):
    """On the card (``on_cuda`` stands in), ``sample_action_pm`` always
    takes the kernel: with autograd not recording it launches; with it
    recording the launcher raises, naming ``no_grad`` and the plain version,
    before it launches anything."""
    calls, launcher = [], kpolicy.policy_mlp_cuda

    def spy(x, eps, trunk, mu, value, log_std, scale):
        calls.append(scale)
        if grad:
            return launcher(x, eps, trunk, mu, value, log_std, scale)
        return kpolicy.policy_mlp_plain(x, eps, trunk, mu, value, log_std, scale)

    monkeypatch.setattr(kernels, 'on_cuda', lambda *ts: True)
    monkeypatch.setattr(kpolicy, 'policy_mlp_cuda', spy)
    pol = make_policy()
    x, eps = torch.randn((12, 8)), torch.randn((2, 8))
    before = kernels.LAUNCHES['policy_mlp']
    with torch.set_grad_enabled(grad):
        if grad:
            with pytest.raises(RuntimeError, match=r'no_grad.*policy_mlp_plain'):
                ppo.sample_action_pm(pol, x, eps, SCALE)
        else:
            out = ppo.sample_action_pm(pol, x, eps, SCALE)
            assert all(t.grad_fn is None for t in out)
    assert calls == [SCALE] and kernels.LAUNCHES['policy_mlp'] == before


def test_strided_noise_reaches_the_kernel_contiguous(monkeypatch):
    """A rank's noise is a strided view of the global draw
    (``ppo._global_normals``: ``[T, A, n * b]`` narrowed to its columns);
    ``sample_action_pm`` hands the kernel whole planes of the same values."""
    seen = []

    def spy(x, eps, trunk, mu, value, log_std, scale):
        seen.append((x.is_contiguous(), eps.is_contiguous()))
        return kpolicy.policy_mlp_plain(x, eps, trunk, mu, value, log_std, scale)

    monkeypatch.setattr(kernels, 'on_cuda', lambda *ts: True)
    monkeypatch.setattr(kpolicy, 'policy_mlp_cuda', spy)
    pol = make_policy()
    x = torch.randn((12, 8), generator=torch.Generator().manual_seed(6))
    full = torch.randn((3, 2, 4 * 8), generator=torch.Generator().manual_seed(7))
    eps = full.narrow(2, 2 * 8, 8)[1]
    assert not eps.is_contiguous()
    with torch.no_grad():
        got = ppo.sample_action_pm(pol, x, eps, SCALE)
        want = sample_pm_ops(pol, x, eps, SCALE)
    assert seen == [(True, True)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
