"""The sharded paths (``parallel/sharding.py``) and the trajectory store on
the card, at world size 1 (one H100: NCCL takes one rank a card).

Every test here needs a CUDA device (``gpu`` marker) and skips without one.
This module imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_parallel_gpu.py -q

Checked at 4096 envs on a world-size-1 NCCL group (a ``FileStore``): the
sharded fused steps (kernels C, F, H) bit-equal to the unsharded ones from
the same card generator state, seed tensor or injected uniforms, with no
host synchronisation; the sharded rollouts (K=1 and K=32) and the reactive
rollout bit-equal to the unsharded ones; a rank's seed tensor offset on the
card keys the same stream as the offset int; ``metrics_summary`` through
NCCL equal to the local means, with no host synchronisation; the native
trajectory writer fed from card tensors, read back equal.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_sharding_cases as cases  # noqa: E402

from gymnasium_planar_robotics_tpu_torch.models import ppo  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.parallel import sharding  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.utils import trajstore  # noqa: E402

pytestmark = pytest.mark.gpu
B = 4096


@pytest.fixture(scope='module')
def mesh():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return sharding.make_mesh('cuda')


def _leaves(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif hasattr(x, '__dataclass_fields__'):
        for k in x.__dataclass_fields__:
            _leaves(getattr(x, k), out)
    return out


def _equal(a, b) -> bool:
    la, lb = _leaves(a, []), _leaves(b, [])
    return len(la) == len(lb) > 0 and all(torch.equal(x, y) for x, y in zip(la, lb))


def _syncs(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum('called a synchronizing' in str(w.message) for w in caught)


def _card_case(name):
    cfg, prm = cases.make_env(name, device='cuda')
    state = cases.episode_state(name, cfg, prm, B, 3)
    m = cases.STEP_CASES[name][1]
    action = torch.rand((B, 2 * m), generator=torch.Generator(device='cuda').manual_seed(4), device='cuda') * 16 - 8
    return cfg, prm, state, action


@pytest.mark.parametrize('name', list(cases.STEP_CASES))
def test_sharded_fused_step_equals_unsharded_on_card(mesh, name):
    model = cases.STEP_CASES[name][0]
    cfg, prm, state, action = _card_case(name)
    sh = sharding.make_sharded_fused_step(model, cfg, prm, mesh)
    un = model.make_fused_step_autoreset(cfg, prm)
    g1, g2 = (torch.Generator(device='cuda').manual_seed(5) for _ in range(2))
    sh(state, action, generator=g1)  # warm-up (and the generators advance alike)
    un(state, action, generator=g2)
    torch.cuda.synchronize()
    got, syncs = _syncs(lambda: sh(state, action, generator=g1))
    assert syncs == 0 and _equal(got, un(state, action, generator=g2))
    seed = torch.tensor([77], dtype=torch.int64, device='cuda')
    assert _equal(sh(state, action, seed=seed), un(state, action, seed=seed))
    u = torch.rand((sh.noise_planes, B), generator=g1, device='cuda')
    assert _equal(sh(state, action, noise=u), un(state, action, noise=u))


@pytest.mark.parametrize('k', [1, 32])
@pytest.mark.parametrize('name', ['pushing', 'planning_m1'])
def test_sharded_rollout_and_offset_card_seed(mesh, name, k):
    model = cases.STEP_CASES[name][0]
    cfg, prm, state, _ = _card_case(name)
    acts = cases.rollout_actions(B, 32, 8).cuda()
    un = model.make_fused_rollout(cfg, prm, steps_per_launch=k)
    sh = sharding.make_sharded_fused_rollout(model, cfg, prm, mesh, steps_per_launch=k)
    seed = torch.tensor([11], dtype=torch.int64, device='cuda')
    assert _equal(sh(state, acts, seed), un(state, acts, seed))
    assert _equal(sh(state, acts, 11), un(state, acts, 11))
    # rank 1's seed, offset on the card, keys the stream of the offset int
    off, syncs = _syncs(lambda: sharding.offset_seed(seed, 1))
    assert syncs == 0 and off.device.type == 'cuda' and int(off) == 11 + sharding.SEED_STRIDE
    assert _equal(un(state, acts, off), un(state, acts, 11 + sharding.SEED_STRIDE))
    assert not _equal(un(state, acts, off)[0], un(state, acts, 11)[0])


def test_sharded_reactive_rollout_equals_unsharded_on_card(mesh):
    cfg, prm, state, _ = _card_case('pushing')
    pcfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(64, 64), rollout_steps=8, action_scale=10.0)
    pol = ppo.init_params(pcfg, torch.Generator(device='cuda').manual_seed(0), device='cuda')
    ps = cases.policy_step_of(pcfg)
    sh = sharding.make_sharded_reactive_rollout(tpush, cfg, prm, ps, 8, mesh)
    un = tpush.make_reactive_rollout(cfg, prm, ps, 8)
    g1, g2 = (torch.Generator(device='cuda').manual_seed(6) for _ in range(2))
    with torch.no_grad():
        assert _equal(sh(state, pol, g1, 13), un(state, pol, g2, 13))


def test_metrics_summary_through_nccl(mesh):
    cfg, prm, state, action = _card_case('planning_m1')
    out = cases.STEP_CASES['planning_m1'][0].make_fused_step_autoreset(cfg, prm)(state, action)
    _, _, rew, term, _, info = out
    torch.cuda.synchronize()
    summary, syncs = _syncs(lambda: sharding.metrics_summary(rew, term, info, mesh))
    local = sharding.metrics_summary(rew, term, info)
    assert syncs == 0 and all(v.device.type == 'cuda' for v in summary.values())
    assert all(torch.equal(summary[k], local[k]) for k in local)
    assert 0.0 < float(summary['wall_collision_rate']) < 1.0


def test_trajstore_native_writer_from_card_tensors(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    g = torch.Generator(device='cuda').manual_seed(0)
    frames = [{'action': torch.rand((512, 2), generator=g, device='cuda'),
               'done': torch.rand(512, generator=g, device='cuda') > 0.5,
               'steps': torch.arange(512, device='cuda', dtype=torch.int32)} for _ in range(20)]
    with trajstore.TrajWriter(tmp_path, shard_bytes=16384) as w:
        for f in frames:
            w.append_pytree(f)
    assert w.frames_written == 20 and len(list(tmp_path.glob('shard_*.bin'))) > 1
    with trajstore.TrajReader(tmp_path) as r:
        for i, f in enumerate(frames):
            got = r.get_arrays(i)
            for a, k in zip(got, sorted(f)):
                np.testing.assert_array_equal(a, f[k].cpu().numpy())
