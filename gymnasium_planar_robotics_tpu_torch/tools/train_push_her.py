"""The pushing HER recipe: DDPG or TD3 with HER on the sparse pushing reward,
on the fused autoreset step (kernel C), with strict evals.

Counterpart of the JAX package's ``tools/train_push_her.py`` (the same flags
and defaults, plus ``--device``).  On the card by default::

    python -m gymnasium_planar_robotics_tpu_torch.tools.train_push_her \\
        --iters 4000 --batch 512 --twin --target-noise 0.1 --policy-delay 2 [--device cpu]

Prints eval rows (strict scoring: ``is_success`` on the episode's final
step, deterministic policy, ``--eval-episodes`` fresh episodes on the eager
step) every ``--eval-every`` iterations and a JSON summary at the end.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gymnasium_planar_robotics_tpu_torch.models import common, her, pushing
from gymnasium_planar_robotics_tpu_torch.tools.transfer_eval import (HORIZON, PUSHING_KW, _pushing_vec, eval_in_engine,
                                                                     pushing_policy)


def build(args):
    """``(config, params, cfg, train_step, runner)`` of the recipe in
    ``args``; the runner is ``her.make_train_step``'s with a replay buffer,
    its generator on the device."""
    device = common.resolve_device(args.device)
    config, params = pushing.make_pushing_env(device=device, **PUSHING_KW)
    cfg = her.HERConfig(
        obs_dim=8, goal_dim=2, action_dim=2, hidden=tuple(args.hidden),
        action_scale=PUSHING_KW['a_max'], rollout_steps=HORIZON,
        relabel_prob=args.relabel, explore_std=args.explore_std,
        explore_eps=args.explore_eps, update_steps=args.update_steps,
        gamma=args.gamma, actor_lr=args.actor_lr, critic_lr=args.critic_lr,
        replay_size=args.replay, minibatch=args.minibatch,
        action_l2=args.action_l2, tau=args.tau,
        twin_critic=args.twin, target_noise=args.target_noise,
        policy_delay=args.policy_delay, n_step=args.n_step,
        explore_per_episode=args.per_episode,
    )
    g = torch.Generator(device=device).manual_seed(args.seed)
    nets = her.init_params(cfg, g, device=device)
    fused = pushing.make_fused_step_autoreset(config, params) if args.fused else None
    train_step, make_opts = her.make_train_step(
        config, params, cfg,
        None if fused is not None else pushing.step_autoreset,
        lambda ach, des, mc, wc: pushing.compute_reward(params, ach, des, wc),
        lambda r: r == -50.0,
        vec_fn=_pushing_vec,
        batched_step_fn=None if fused is None else (lambda s, a: fused(s, a, generator=g)),
    )
    state, obs, _ = pushing.init_batch(config, params, args.batch, g)
    runner = (state, obs, nets, *make_opts(nets), her.init_replay(cfg, device), g)
    return config, params, cfg, train_step, runner


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--iters', type=int, default=4000)
    p.add_argument('--batch', type=int, default=512)
    p.add_argument('--hidden', type=int, nargs='+', default=[256, 256])
    p.add_argument('--gamma', type=float, default=0.95)
    p.add_argument('--tau', type=float, default=0.05)
    p.add_argument('--actor-lr', type=float, default=3e-4)
    p.add_argument('--critic-lr', type=float, default=1e-3)
    p.add_argument('--relabel', type=float, default=0.8)
    p.add_argument('--explore-std', type=float, default=0.2)
    p.add_argument('--explore-eps', type=float, default=0.3)
    p.add_argument('--update-steps', type=int, default=20)
    p.add_argument('--replay', type=int, default=4_000_000)
    p.add_argument('--minibatch', type=int, default=4096)
    p.add_argument('--action-l2', type=float, default=1.0)
    p.add_argument('--twin', action='store_true')
    p.add_argument('--target-noise', type=float, default=0.0)
    p.add_argument('--policy-delay', type=int, default=1)
    p.add_argument('--n-step', type=int, default=1)
    p.add_argument('--per-episode', action='store_true',
                   help='temporally correlated exploration (episode-held coin + direction)')
    p.add_argument('--fused', action='store_true', default=True)
    p.add_argument('--no-fused', dest='fused', action='store_false')
    p.add_argument('--eval-every', type=int, default=1000)
    p.add_argument('--eval-episodes', type=int, default=512)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    config, params, cfg, step, runner = build(args)
    t0 = time.time()
    best = 0.0
    for i in range(args.iters):
        runner, m = step(runner)
        if i % 100 == 0 or i == args.iters - 1:
            print(f'iter {i:6d}  ep-succ {float(m["episode_success_rate"]):.3f}  '
                  f'c-loss {float(m["critic_loss"]):.4f}  ({time.time() - t0:.0f}s)', flush=True)
        if (i + 1) % args.eval_every == 0 or i == args.iters - 1:
            res = eval_in_engine(pushing, config, params, pushing_policy(runner[2], cfg.action_scale),
                                 args.eval_episodes)
            best = max(best, res['success'])
            print(f'EVAL iter {i:6d}: success {res["success"]:.3f} '
                  f'(any {res["success_any"]:.3f}) return {res["return_mean"]:.1f}', flush=True)
    summary = {
        'metric': 'pushing HER strict success', 'value': best,
        'env_steps': args.iters * args.batch * HORIZON, 'wall_s': round(time.time() - t0, 1),
        'recipe': dict(vars(args)),
    }
    print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
