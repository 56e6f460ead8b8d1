"""The HER learning gate of the JAX package's ``tests/test_her_learning.py``
on the port: DDPG+HER on sparse 1-mover planning over the fused step
(kernel F on the card).

The gate: the episode success of the last 30 of 250 iterations beats that of
iterations 10-40 by 0.08 and exceeds 0.38, and the same learner without
relabelling ends more than 0.10 below.  ``gate`` runs one seed; the command
runs several, on the card unless told otherwise::

    python -m gymnasium_planar_robotics_tpu_torch.tools.her_gate --seeds 0 1 2 3 [--iters 250] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, her, planning
from gymnasium_planar_robotics_tpu_torch.ops import kernels

B = 256
ITERS = 250


def curve(relabel_prob: float, seed: int, iters: int = ITERS, device=None) -> np.ndarray:
    """``[iters]`` episode success rates of the gate's learner (256 envs,
    (64, 64), 16 rollout steps, 8 updates, no replay buffer) with
    ``relabel_prob``; the learner's and the envs' draws from one generator
    seeded ``seed``.  Reads the rates back once, at the end."""
    device = common.resolve_device(device)
    config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0, device=device)
    cfg = her.HERConfig(obs_dim=2, goal_dim=2, action_dim=2, hidden=(64, 64), action_scale=3.0, rollout_steps=16,
                        relabel_prob=relabel_prob, explore_std=0.2, update_steps=8)
    g = torch.Generator(device=device).manual_seed(seed)
    nets = her.init_params(cfg, g, device=device)
    fused = planning.make_fused_step_autoreset(config, params)
    step, make_opts = her.make_train_step(
        config, params, cfg, None, lambda ach, des, mc, wc: planning.compute_reward(config, params, ach, des, mc, wc),
        lambda r: torch.abs(r) == 50.0, batched_step_fn=lambda s, a: fused(s, a, generator=g))
    state, obs, _ = planning.init_batch(config, params, B, g)
    runner = (state, obs, nets, *make_opts(nets), g)
    rates = []
    for _ in range(iters):
        runner, m = step(runner)
        rates.append(m['episode_success_rate'])
    return torch.stack(rates).cpu().numpy()


def gate(seed: int = 0, iters: int = ITERS, device=None) -> dict:
    """Both learners at ``seed``: the gate's three numbers, whether each
    threshold holds, the curves (means of 10 iterations), kernel F's
    launches and the seconds taken."""
    t0 = time.perf_counter()
    before = kernels.LAUNCHES['planning_autoreset']
    rates = curve(0.8, seed, iters, device)
    no_her = curve(0.0, seed, iters, device)
    early, late, late_no = float(rates[10:40].mean()), float(rates[-30:].mean()), float(no_her[-30:].mean())
    return {
        'seed': seed, 'iters': iters, 'early': early, 'late': late, 'late_no_relabel': late_no,
        'lift_held': late > early + 0.08, 'level_held': late > 0.38, 'relabel_held': late > late_no + 0.10,
        'finite': bool(np.isfinite(rates).all() and np.isfinite(no_her).all()),
        'kernel_F_launches': kernels.LAUNCHES['planning_autoreset'] - before,
        'curve_her_every_10': [float(rates[i:i + 10].mean()) for i in range(0, iters, 10)],
        'curve_no_relabel_every_10': [float(no_her[i:i + 10].mean()) for i in range(0, iters, 10)],
        'seconds': time.perf_counter() - t0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, nargs='+', default=[0])
    ap.add_argument('--iters', type=int, default=ITERS)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(gate(seed, args.iters, args.device)), flush=True)


if __name__ == '__main__':
    main()
