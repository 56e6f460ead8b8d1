"""Train DDPG+HER on the sparse planning task, on the card.

Counterpart of the JAX package's ``examples/train_her.py``: env rollout on
the eager ``planning.step_autoreset``, 'future' hindsight relabelling with
rewards recomputed from the collision flags (the reference's batched
``compute_reward(achieved, desired, info)``), then the critic and actor
updates, one iteration at a time on the device::

    python -m gymnasium_planar_robotics_tpu_torch.examples.train_her [--batch 256] [--iters 250] [--relabel 0.8] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, her, planning


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--iters', type=int, default=250)
    ap.add_argument('--relabel', type=float, default=0.8, help='future-relabel probability (0 disables HER)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args(argv)

    dev = common.resolve_device(args.device)
    config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0, device=dev)
    assert config.reward_mode == 'sparse'
    cfg = her.HERConfig(obs_dim=2, goal_dim=2, action_dim=2, hidden=(64, 64), action_scale=3.0, rollout_steps=16,
                        relabel_prob=args.relabel, explore_std=0.2, update_steps=8)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    nets = her.init_params(cfg, g, device=dev)
    train_step, make_opts = her.make_train_step(
        config, params, cfg, planning.step_autoreset,
        lambda ach, des, mc, wc: planning.compute_reward(config, params, ach, des, mc, wc),
        lambda r: torch.abs(r) == 50.0)
    state, obs, _ = planning.init_batch(config, params, args.batch, g)
    runner = (state, obs, nets, *make_opts(nets), g)

    t0 = time.perf_counter()
    for it in range(args.iters):
        runner, metrics = train_step(runner)
        if it % 25 == 0 or it == args.iters - 1:
            print(f'iter {it:4d}  episode_success={float(metrics["episode_success_rate"]):.3f}  '
                  f'critic_loss={float(metrics["critic_loss"]):.4f}  '
                  f'{args.batch * cfg.rollout_steps * (it + 1) / (time.perf_counter() - t0):,.0f} env-steps/s',
                  flush=True)
    return metrics


if __name__ == '__main__':
    main()
