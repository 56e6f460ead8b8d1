"""DDPG/TD3+HER (``models/her.py``) and ``utils/checkpoint.py`` on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_her_gpu.py -q

Checked: one HER iteration over pushing's fused step on the card launches
kernel C once a rollout step and no other kernel, makes no host
synchronisation in the rollout, and, at ``std_noise=0`` with the same
injected env uniforms and learner draws, gives the weights, the buffer and
the env state of the same iteration on the CPU (the plain kernel C) within
kernel C's tolerances (state: the plane-class tolerances of
``test_torch_kernels_gpu.py``; weights rtol 1e-4 / atol 2e-5, a few
percent of one Adam step of 3e-4 to 1e-3: float32 products on the card and
the CPU differ in rounding, and FMA contraction in kernel C moves a state by
ulps); and the checkpoint round trip of a runner on the card, and a resumed
iteration, bit for bit.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import her, pushing
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.tools.transfer_eval import _pushing_vec
from gymnasium_planar_robotics_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.gpu

CFG = her.HERConfig(obs_dim=8, goal_dim=2, action_dim=2, hidden=(64, 64), action_scale=10.0, rollout_steps=10,
                    update_steps=4, replay_size=65536, minibatch=1024, action_l2=1.0, twin_critic=True,
                    target_noise=0.1, policy_delay=2)
B = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def learner(device, noise_steps=None, seed=0):
    """(train_step, runner) of HER over pushing's fused step on ``device``
    (``std_noise=0``); with ``noise_steps`` ``[T, planes, B]`` the fused
    step takes step t's uniforms at its t-th call (the restarts' draws)."""
    cfg, prm = pushing.make_pushing_env(std_noise=0.0, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    fused = pushing.make_fused_step_autoreset(cfg, prm)
    calls = []
    if noise_steps is not None:
        noise_steps = noise_steps.to(device)

    def step_fn(s, a):
        u = None if noise_steps is None else noise_steps[len(calls) % len(noise_steps)]
        calls.append(1)
        return fused(s, a, noise=u, generator=g)

    train_step, make_opts = her.make_train_step(
        cfg, prm, CFG, None, lambda ach, des, mc, wc: pushing.compute_reward(prm, ach, des, wc),
        lambda r: r == -50.0, vec_fn=_pushing_vec, batched_step_fn=step_fn)
    # the same start on either device: made on the CPU, then moved
    cfg0, prm0 = pushing.make_pushing_env(std_noise=0.0, device='cpu')
    state, obs, _ = pushing.init_batch(cfg0, prm0, B, torch.Generator().manual_seed(seed + 1))
    state = pushing.state_from_numpy(pushing.state_to_numpy(state), device=device)
    obs = {k: v.to(device) for k, v in obs.items()}
    nets = her.init_params(CFG, torch.Generator().manual_seed(seed + 2), device=device)
    return train_step, (state, obs, nets, *make_opts(nets), her.init_replay(CFG, device), g), fused.noise_planes


def draws_for(b, seed=3):
    """Every learner draw of one iteration, made on the CPU."""
    g = torch.Generator().manual_seed(seed)
    T, A, U, mb = CFG.rollout_steps, CFG.action_dim, CFG.update_steps, CFG.minibatch
    s = CFG.action_scale
    return {'explore_coin': torch.rand((b,), generator=g),
            'explore_held': torch.rand((b, A), generator=g) * 2 * s - s,
            'noise': torch.randn((T, b, A), generator=g), 'coin': torch.rand((T, b), generator=g),
            'rand_a': torch.rand((T, b, A), generator=g) * 2 * s - s,
            'relabel': (torch.rand((T, b), generator=g), torch.rand((T, b), generator=g)),
            'sample_idx': torch.randint(0, 2 * T * b, (U, mb), generator=g),
            'target_noise': torch.randn((U, mb, A), generator=g)}


def to(d, device):
    return {k: tuple(x.to(device) for x in v) if isinstance(v, tuple) else v.to(device) for k, v in d.items()}


def test_her_iteration_on_the_card_matches_the_plain_version(cuda):
    """Launches, host synchronisations, and the card against the CPU."""
    n_planes = pushing.make_fused_step_autoreset(*pushing.make_pushing_env(std_noise=0.0, device='cpu')).noise_planes
    u = torch.rand((CFG.rollout_steps, n_planes, B), generator=torch.Generator().manual_seed(4))
    step_c, runner_c, _ = learner(cuda, u)
    step_p, runner_p, _ = learner('cpu', u)
    d = draws_for(B)
    d_cuda = to(d, cuda)
    torch.cuda.synchronize()
    # the rollout alone: one kernel C launch a step, no host synchronisation
    state, obs, nets, *_, g = runner_c
    kernels.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            step_c.collect(state, obs, nets, g, d_cuda)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if 'called a synchronizing' in str(w.message)]
    assert not syncs, syncs[:3]
    assert kernels.LAUNCHES['pushing_autoreset'] == CFG.rollout_steps and sum(kernels.LAUNCHES.values()) == \
        CFG.rollout_steps
    # a whole iteration on both devices from the same start
    step_c, runner_c, _ = learner(cuda, u)
    (s_c, _, nets_c, _, _, buf_c, _), m_c = step_c(runner_c, draws=d_cuda)
    (s_p, _, nets_p, _, _, buf_p, _), m_p = step_p(runner_p, draws=d)
    torch.cuda.synchronize()
    for f in dataclasses.fields(s_p):
        want, got = getattr(s_p, f.name), getattr(s_c, f.name).cpu()
        if want.dtype.is_floating_point:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=f.name)
        else:
            assert torch.equal(got, want), f.name
    assert buf_c['filled'] == buf_p['filled'] == 2 * CFG.rollout_steps * B
    for k in her.REPLAY_FIELDS:
        torch.testing.assert_close(buf_c[k].cpu(), buf_p[k], rtol=1e-4, atol=1e-4, msg=k)
    for (name, a), b in zip(nets_p.state_dict().items(), nets_c.state_dict().values()):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=2e-5, msg=name)
    for k in m_p:
        torch.testing.assert_close(m_c[k].cpu(), m_p[k], rtol=1e-3, atol=1e-5, msg=k)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Saved after two iterations, restored into a fresh runner on the
    card: every tensor equal, and the next iteration equal to the
    uninterrupted run's, bit for bit."""
    step, runner, _ = learner(cuda)
    for _ in range(2):
        runner, _ = step(runner)
    checkpoint.save(tmp_path, runner, step=2)
    step2, fresh, _ = learner(cuda, seed=7)
    restored = checkpoint.restore(tmp_path, fresh)
    assert restored[2] is fresh[2] and restored[0].pos.device.type == 'cuda'
    runner, m = step(runner)
    restored, m2 = step2(restored)
    for k in m:
        assert torch.equal(m[k], m2[k]), k
    for a, b in zip(runner[2].state_dict().values(), restored[2].state_dict().values()):
        assert torch.equal(a, b)
    for k in her.REPLAY_FIELDS:
        assert torch.equal(runner[5][k], restored[5][k]), k
    for f in dataclasses.fields(runner[0]):
        assert torch.equal(getattr(runner[0], f.name), getattr(restored[0], f.name)), f.name
    assert torch.equal(runner[6].get_state(), restored[6].get_state())
    assert np.isfinite(float(m['critic_loss']))
