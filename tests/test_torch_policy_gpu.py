"""Kernel P, the reactive policy step (``ops/kernels/policy``), on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX; on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_policy_gpu.py -q

Each test runs ``ppo.sample_action_pm`` under ``torch.no_grad`` (one launch
of the kernel) against the plain torch ops (``policy_mlp_plain``: cuBLAS
products, TF32 off) on the same inputs.  raw, logp and value agree within
2e-6 of the reference's largest magnitude of each (a tenth of the
benchmark's ``policy_gap`` limit: the products sum in another order, and
nvcc contracts multiply-adds); the action is the clamp of the kernel's own
raw bit for bit.  An env's arithmetic does not depend on the batch, so the
first envs of a wide batch equal a narrow batch bit for bit.
"""

import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import ppo
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import policy as kpolicy

pytestmark = pytest.mark.gpu
REL = 2e-6
SCALE = 10.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def make_policy(obs_dim, hidden, action_dim, device, seed=0):
    """The JAX package's initial distributions, with biases and log_std
    drawn too, so that every term is exercised."""
    cfg = ppo.PPOConfig(obs_dim=obs_dim, action_dim=action_dim, hidden=hidden, action_scale=SCALE)
    g = torch.Generator(device=device).manual_seed(seed)
    pol = ppo.init_params(cfg, g, device=device)
    with torch.no_grad():
        for layer in pol.trunk:
            layer.bias.copy_(torch.randn(layer.bias.shape, generator=g, device=device) * 0.1)
        pol.mu.weight.mul_(30.0)
        pol.mu.bias.copy_(torch.randn(pol.mu.bias.shape, generator=g, device=device) * 0.5)
        pol.value.bias.fill_(0.25)
        pol.log_std.copy_(torch.linspace(-0.6, 0.4, action_dim, device=device))
    return pol


def inputs(obs_dim, action_dim, batch, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((obs_dim, batch), generator=g, device=device)
    eps = torch.randn((action_dim, batch), generator=g, device=device)
    return x, eps


def reference(pol, x, eps):
    with torch.no_grad():
        return kpolicy.policy_mlp_plain(x, eps, *pol.params_pm(), SCALE)


def assert_matches(got, want):
    action, raw, logp, value = got
    for name, g, w in (('raw', raw, want[1]), ('logp', logp, want[2]), ('value', value, want[3])):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        gap = float((g - w).abs().max()) / float(w.abs().max())
        assert gap <= REL, f'{name}: {gap:.3e} of its largest magnitude'
    assert torch.equal(action, torch.clamp(raw, -SCALE, SCALE))


@pytest.mark.parametrize('obs_dim,hidden,batch', [
    (12, (256, 256), 65536),
    (6, (64, 64), 4096),
    (64, (512, 512), 4096),
    (12, (256,), 4096),
    (12, (128, 256, 96), 4096),
    (12, (256, 256), 4097),
    (12, (1024,), 1000),
    (7, (100, 33), 31),
])
def test_kernel_matches_plain(cuda, obs_dim, hidden, batch):
    pol = make_policy(obs_dim, hidden, 2, cuda)
    x, eps = inputs(obs_dim, 2, batch, cuda)
    before = kernels.LAUNCHES['policy_mlp']
    with torch.no_grad():
        got = ppo.sample_action_pm(pol, x, eps, SCALE)
    assert kernels.LAUNCHES['policy_mlp'] == before + 1
    torch.cuda.synchronize()
    assert_matches(got, reference(pol, x, eps))


def test_batch_prefix_is_bit_equal(cuda):
    pol = make_policy(12, (256, 256), 2, cuda)
    x, eps = inputs(12, 2, 65536, cuda)
    with torch.no_grad():
        wide = ppo.sample_action_pm(pol, x, eps, SCALE)
        narrow = ppo.sample_action_pm(pol, x[:, :4096].contiguous(), eps[:, :4096].contiguous(), SCALE)
        # and a window that starts mid-tile
        mid = ppo.sample_action_pm(pol, x[:, 100:4196].contiguous(), eps[:, 100:4196].contiguous(), SCALE)
    for w, n, m in zip(wide, narrow, mid):
        assert torch.equal(w[..., :4096], n)
        assert torch.equal(w[..., 100:4196], m)


def test_in_place_update_is_seen(cuda):
    pol = make_policy(12, (256, 256), 2, cuda)
    x, eps = inputs(12, 2, 4096, cuda)
    with torch.no_grad():
        first = ppo.sample_action_pm(pol, x, eps, SCALE)
        for p in pol.parameters():
            p.add_(0.05 * torch.ones_like(p))
        second = ppo.sample_action_pm(pol, x, eps, SCALE)
    assert not torch.equal(first[1], second[1]) and not torch.equal(first[3], second[3])
    assert_matches(second, reference(pol, x, eps))


def test_adam_step_is_seen(cuda):
    """An optimizer's in-place update between two calls, as PPO makes one."""
    pol = make_policy(12, (64, 64), 2, cuda)
    x, eps = inputs(12, 2, 512, cuda)
    opt = torch.optim.Adam(pol.parameters(), lr=1e-2)
    loss = kpolicy.policy_mlp_plain(x, eps, *pol.params_pm(), SCALE)[3].square().mean()
    loss.backward()
    opt.step()
    with torch.no_grad():
        got = ppo.sample_action_pm(pol, x, eps, SCALE)
    assert_matches(got, reference(pol, x, eps))


def test_generator_noise_equals_handed_noise(cuda):
    pol = make_policy(12, (256, 256), 2, cuda)
    x, _ = inputs(12, 2, 4096, cuda)
    for gdev in (cuda, torch.device('cpu')):
        with torch.no_grad():
            drawn = ppo.sample_action_pm(pol, x, torch.Generator(device=gdev).manual_seed(7), SCALE)
            eps = torch.randn((2, 4096), generator=torch.Generator(device=gdev).manual_seed(7), device=gdev).to(cuda)
            handed = ppo.sample_action_pm(pol, x, eps, SCALE)
        for d, h in zip(drawn, handed):
            assert torch.equal(d, h)


def test_autograd_recording_raises_on_the_card(cuda):
    """The kernel has no backward: with autograd recording the card's path
    raises, naming the plain version, and launches nothing."""
    pol = make_policy(12, (64, 64), 2, cuda)
    x, eps = inputs(12, 2, 256, cuda)
    before = kernels.LAUNCHES['policy_mlp']
    with pytest.raises(RuntimeError, match=r'no_grad.*policy_mlp_plain'):
        ppo.sample_action_pm(pol, x, eps, SCALE)
    with pytest.raises(RuntimeError, match='no backward'):
        kpolicy.policy_mlp(x, eps, *pol.params_pm(), SCALE)
    assert kernels.LAUNCHES['policy_mlp'] == before


def test_shard_noise_view_through_the_reactive_train_step(cuda):
    """A rank's share of the global noise (``ppo._global_normals`` on a
    card generator: ``[T, A, n * b]`` narrowed to its ``b`` columns, a
    strided view) through ``make_train_step_reactive``'s policy step in a
    pushing reactive rollout: one launch a step, bit-equal to the same
    noise handed in whole."""
    from gymnasium_planar_robotics_tpu_torch.models import pushing

    cfg, prm = pushing.make_pushing_env(device=cuda)
    pcfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(64, 64), rollout_steps=6, action_scale=SCALE)
    pol = make_policy(12, (64, 64), 2, cuda)
    train_step, _ = ppo.make_train_step_reactive(
        pcfg, lambda ps: pushing.make_reactive_rollout(cfg, prm, ps, pcfg.rollout_steps, dense_reward=True))
    roll = pushing.make_reactive_rollout(cfg, prm, train_step.policy_step, pcfg.rollout_steps, dense_reward=True)
    b, n = 1000, 4
    g = torch.Generator(device=cuda).manual_seed(11)
    state, _, _ = pushing.init_batch(cfg, prm, b, g)
    full = torch.randn((pcfg.rollout_steps, 2, n * b), generator=g, device=cuda)
    view = full.narrow(2, 2 * b, b)
    assert not view[0].is_contiguous()
    with torch.no_grad():
        before = kernels.LAUNCHES['policy_mlp']
        got = roll(state, pol, None, 21, policy_xs=view)
        assert kernels.LAUNCHES['policy_mlp'] == before + pcfg.rollout_steps
        want = roll(state, pol, None, 21, policy_xs=view.contiguous())
    torch.cuda.synchronize()
    got_leaves, want_leaves = [], []
    for out, leaves in ((got, got_leaves), (want, want_leaves)):
        stack = [out]
        while stack:
            v = stack.pop()
            if isinstance(v, torch.Tensor):
                leaves.append(v)
            elif isinstance(v, (tuple, list)):
                stack.extend(v)
            elif hasattr(v, '__dataclass_fields__'):
                stack.extend(getattr(v, k) for k in v.__dataclass_fields__)
    assert len(got_leaves) == len(want_leaves) > 0
    assert all(torch.equal(a, w) for a, w in zip(got_leaves, want_leaves))


def test_wrapper_raises_on_the_card(cuda):
    pol = make_policy(12, (64, 64), 2, cuda)
    x, eps = inputs(12, 2, 256, cuda)
    trunk, mu, value, log_std = pol.params_pm()
    with torch.no_grad():
        with pytest.raises(ValueError, match='contiguous'):
            kpolicy.policy_mlp(x.T.contiguous().T, eps, trunk, mu, value, log_std, SCALE)
        with pytest.raises(ValueError, match='lies on'):
            kpolicy.policy_mlp(x, eps, trunk, (mu[0].cpu(), mu[1]), value, log_std, SCALE)
        with pytest.raises(TypeError, match='float32'):
            kpolicy.policy_mlp(x, eps.double(), trunk, mu, value, log_std, SCALE)
