"""The reference against the program's plain versions on the CPU at a tiny
size: its constants, its Philox stream, one step of each kernel and whole
rollouts, bit for bit (the plain versions round every operation on its
own, in the kernels' draw order, as the reference does)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import opcount  # noqa: E402
from reference import noise as rnoise  # noqa: E402
from reference import planning as rplan  # noqa: E402
from reference import policy as rpolicy  # noqa: E402
from reference import pushing as rpush  # noqa: E402
from traffic.common import make_env  # noqa: E402

from gymnasium_planar_robotics_tpu_torch.models import ppo  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise as pnoise  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti  # noqa: E402
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush  # noqa: E402

CPU = torch.device('cpu')


def config(name):
    return json.loads((HERE / 'configs' / f'{name}.json').read_text())


@pytest.mark.parametrize('seed', [0, 7, 2**31 + 5, 2**40 + 3])
def test_philox_matches_the_programs_stream(seed):
    want = pnoise.philox_uniforms(seed, 37, 11)
    assert torch.equal(rnoise.philox_uniforms(seed, 0, 37, 11, CPU), want)
    assert torch.equal(rnoise.philox_uniforms(seed, 5, 30, 11, CPU), want[5:35])


def test_constants_match_the_programs():
    cfg = config('pushing-default')
    _, pc, pp = make_env(cfg, CPU)
    kc = kpush.make_kernel_consts(pc, pp, cfg['cand_k'])
    mine = rpush.constants(cfg)
    for k, v in mine.items():
        if k in kc.f:
            assert v == kc.f[k], k
    cfg = config('planning-4mover')
    _, qc, qp = make_env(cfg, CPU)
    mc = kmulti.make_multi_kernel_consts(qc, qp, cfg['cand_k'])
    mine = rplan.constants(cfg)
    for k in ('dt', 'std_pos', 'std_vel', 'x0', 'x1', 'y0', 'y1', 'fx0', 'fx1', 'fy0', 'fy1', 'threshold',
              'max_episode_steps', 'min_x', 'min_y', 'span_x', 'span_y', 'v_max', 'a_max'):
        assert mine[k] == mc.base.f[k], k
    assert mine['c_wall'] == mc.f['c_wall_x'][0] and mine['c_sample'] == mc.f['c_sample_x'][0]
    assert mine['pair_sum'] == mc.f['pair_sum'][0] and mine['sample_pair_sum'] == mc.f['sample_pair_sum_x'][0]
    assert mine['min_goal_dist'] == mc.f['min_goal_dist'][0]


def _rollout_state(mod, pc, pp, b, seed, steps=3):
    gen = torch.Generator().manual_seed(seed)
    state = mod.init_batch(pc, pp, b, generator=gen)[0]
    roll = mod.make_fused_rollout(pc, pp)
    m = getattr(pc, 'num_movers', 1)
    shape = (steps, b, 2) if m == 1 else (steps, b, m, 2)
    acts = (torch.rand(shape, generator=gen) * 2 - 1) * 10.0
    return roll(state, acts, seed)[0]


@pytest.mark.parametrize('k', [1, 32])
def test_pushing_rollout_matches_the_programs(k):
    cfg = config('pushing-default')
    mod, pc, pp = make_env(cfg, CPU)
    b, t = 12, 40
    state = _rollout_state(mod, pc, pp, b, 3)
    gen = torch.Generator().manual_seed(4)
    acts = (torch.rand((t, b, 2), generator=gen) * 2 - 1) * 12.0
    got = mod.make_fused_rollout(pc, pp, cfg['cand_k'], steps_per_launch=k)(state, acts, 1234)
    planes, rew, term, trunc, _ = rpush.rollout(cfg, rpush.state_planes(state), acts, 1234, k)
    assert torch.equal(rpush.state_planes(got[0]), planes)
    assert torch.equal(got[1], rew) and torch.equal(got[2], term) and torch.equal(got[3], trunc)
    assert bool(term.any() | trunc.any())  # episodes end inside the stretch


def test_pushing_features_match_c_feat():
    cfg = config('pushing-default')
    mod, pc, pp = make_env(cfg, CPU)
    b = 9
    planes = rpush.state_planes(_rollout_state(mod, pc, pp, b, 5))
    kc = kpush.make_kernel_consts(pc, pp, cfg['cand_k'])
    u = rnoise.launch_uniforms(77, rpush.noise_planes(40, cfg['cand_k']), b, CPU)
    act = torch.rand((2, b), generator=torch.Generator().manual_seed(1)) * 20 - 10
    out, blocks = kpush.pushing_autoreset_plain(planes, act, kc, u, emit_features=True)
    st, wall, reached, mine = rpush.step(rpush.constants(cfg), 40, cfg['cand_k'], u, list(planes), act[0], act[1])
    assert torch.equal(torch.stack(st), out[:19]) and torch.equal(mine, blocks)
    assert torch.equal(wall, out[33] > 0.5)


def test_planning_rollout_matches_the_programs():
    cfg = config('planning-4mover')
    mod, pc, pp = make_env(cfg, CPU)
    b, t = 10, 30
    state = _rollout_state(mod, pc, pp, b, 6)
    gen = torch.Generator().manual_seed(8)
    acts = (torch.rand((t, b, 4, 2), generator=gen) * 2 - 1) * 12.0
    got = mod.make_fused_rollout(pc, pp, cfg['cand_k'])(state, acts, 99)
    planes, rew, term, trunc, _ = rplan.rollout(cfg, rplan.state_planes(state), acts, 99)
    assert torch.equal(rplan.state_planes(got[0]), planes)
    assert torch.equal(got[1], rew) and torch.equal(got[2], term) and torch.equal(got[3], trunc)
    assert bool(term.any())


def test_policy_matches_the_programs():
    hidden = [32, 16]
    flat = torch.randn(sum(int(np.prod(s)) for _, s in rpolicy.shapes(12, hidden, 2)),
                       generator=torch.Generator().manual_seed(3))
    w = rpolicy.unpack(flat, 12, hidden, 2)
    pol = ppo.ActorCritic(12, tuple(hidden), 2, device='cpu')
    with torch.no_grad():
        for i, layer in enumerate(pol.trunk):
            layer.weight.copy_(w[f'trunk{i}.weight'])
            layer.bias.copy_(w[f'trunk{i}.bias'])
        for head in ('mu', 'value'):
            getattr(pol, head).weight.copy_(w[f'{head}.weight'])
            getattr(pol, head).bias.copy_(w[f'{head}.bias'])
        pol.log_std.copy_(w['log_std'])
        x, eps = torch.randn(12, 50), torch.randn(2, 50)
        _, raw, logp, value = ppo.sample_action_pm(pol, x, eps, 10.0)
        r_raw, r_logp, r_value = rpolicy.sample(w, x, eps, 2)
    for a, b in ((raw, r_raw), (logp, r_logp), (value, r_value)):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    t_raw, _, t_value = rpolicy.sample(w, x, eps, 2, lower=True)
    assert not torch.allclose(t_value, r_value, rtol=1e-5, atol=1e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3.0e-3])
    y = rpolicy.tf32(x)
    assert y[:2].tolist() == [1.0, 1.0 + 2**-10]
    assert y[2].item() == 1.0 and y[3].item() == 1.0 + 2**-9  # ties to even
    assert y[4].item() == -1.0
    bits = y.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


@pytest.mark.parametrize('name', ['pushing-default', 'planning-4mover'])
def test_the_frozen_work_is_the_references(name):
    """``costs/<config>.json`` holds the counts ``opcount`` takes from the
    reference's operations."""
    frozen = json.loads((HERE / 'costs' / f'{name}.json').read_text())
    derived = opcount.derive(config(name))
    for part, counts in derived.items():
        assert {k: frozen[part][k] for k in counts} == counts, part


def test_opcount_counts_what_the_outputs_need():
    def fn(x, c):
        dead = torch.cos(x)  # noqa: F841
        y = torch.where(x > 0, x, 1.0)
        return rnoise.sqrt(y * y + 1.0) / 2.0, (x[None].expand(3, -1) > 0).any(0), torch.clamp(x, -c, c)

    x = torch.rand(4)
    # compare, select, multiply, add; three compares and two ors; a negation and two bounds
    assert opcount.count(fn, (x, x)) == {'f32': 4 + 5 + 3, 'special': 2}
