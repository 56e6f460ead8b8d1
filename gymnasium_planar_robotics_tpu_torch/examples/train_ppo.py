"""Train PPO on the batched planning env, on the card.

Counterpart of the JAX package's ``examples/train_ppo.py``: every iteration
is one rollout of the eager ``planning.step_autoreset`` over the batch, GAE
and the PPO epochs, all on the device::

    python -m gymnasium_planar_robotics_tpu_torch.examples.train_ppo [--batch 1024] [--iters 500] [--movers 1] \\
        [--dense] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, planning, ppo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=1024)
    ap.add_argument('--iters', type=int, default=500)
    ap.add_argument('--movers', type=int, default=1)
    ap.add_argument('--dense', action='store_true', help='use shaped rewards')
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args(argv)

    dev = common.resolve_device(args.device)
    config, params = planning.make_planning_env(np.ones((3, 3)), args.movers, std_noise=1e-5, a_max=3.0,
                                                reward_mode='dense' if args.dense else 'sparse', device=dev)
    cfg = ppo.PPOConfig(obs_dim=3 * config.num_movers * 2, action_dim=config.num_movers * 2, rollout_steps=16,
                        learning_rate=1e-3)
    policy = ppo.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    train_step, make_opt = ppo.make_train_step(config, params, cfg, planning.step_autoreset)
    g = torch.Generator(device=dev).manual_seed(1)
    state, obs, _ = planning.init_batch(config, params, args.batch, g)
    obs_vec = torch.cat([obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1).to(torch.float32)
    runner = (state, obs_vec, policy, make_opt(policy), g)

    t0 = time.perf_counter()
    for i in range(args.iters):
        runner, metrics = train_step(runner)
        if i % 25 == 0:
            sps = args.batch * cfg.rollout_steps * (i + 1) / (time.perf_counter() - t0)
            print(f'iter {i:5d}  reward {float(metrics["reward_mean"]):8.3f}  loss {float(metrics["loss"]):8.3f}  '
                  f'done% {100 * float(metrics["done_rate"]):5.1f}  {sps:,.0f} env-steps/s', flush=True)
    return metrics


if __name__ == '__main__':
    main()
