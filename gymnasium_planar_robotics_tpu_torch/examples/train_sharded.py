"""PPO over ranks with the fused env step: data parallelism, one rank a card.

Counterpart of the JAX package's ``examples/train_sharded.py``.  Each rank
of a ``torch.distributed`` group holds an equal shard of the env batch and
steps it with the fused autoreset step (kernel F; with ``--reactive``, the
reactive plane-form rollout, kernel F between policy launches); the PPO
gradients are averaged over the ranks before every Adam step, the only
collective besides the metrics' means.  One rank per card::

    torchrun --nproc_per_node N -m gymnasium_planar_robotics_tpu_torch.examples.train_sharded \\
        [--batch 4096] [--iters 100] [--reactive]

or alone (a world-size-1 group on a ``FileStore``, no network)::

    python -m gymnasium_planar_robotics_tpu_torch.examples.train_sharded [--device cpu]

``--batch`` is the global batch; it must split into equal shards.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning, ppo
from gymnasium_planar_robotics_tpu_torch.parallel import sharding


def build(args, mesh):
    """``(train_step, runner)`` on this rank's shard of ``args.batch`` envs:
    every rank builds the same global batch and policy from the same seeds
    and keeps its shard."""
    dev = sharding.mesh_device(mesh)
    config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0, reward_mode='dense',
                                                num_cycles=args.cycles, device=dev)
    cfg = ppo.PPOConfig(obs_dim=6, action_dim=2, rollout_steps=args.rollout, learning_rate=1e-3, action_scale=3.0)
    policy = ppo.init_params(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    g_env = torch.Generator(device=dev).manual_seed(args.seed + 1)
    state, obs, _ = planning.init_batch(config, params, args.batch, g_env)
    state, obs = sharding.shard_batch(state, mesh), sharding.shard_batch(obs, mesh)
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    if args.reactive:
        # the rollout keeps the env state in the kernel's plane layout; the
        # plane kernels score sparsely, so build them from a sparse config
        # and let the reactive rollout compute the dense shaping
        kconfig, kparams = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0,
                                                      num_cycles=args.cycles, device=dev)
        train_step, make_opt = ppo.make_train_step_reactive(
            cfg, lambda ps: sharding.make_sharded_reactive_rollout(planning, kconfig, kparams, ps, cfg.rollout_steps,
                                                                   mesh, dense_reward=True), mesh=mesh)
        return train_step, (state, policy, make_opt(policy), g, 0)
    fused = sharding.make_sharded_fused_step(planning, config, params, mesh)
    train_step, make_opt = ppo.make_train_step(config, params, cfg, batched_step_fn=lambda s, a: fused(s, a, generator=g),
                                               mesh=mesh)
    obs_vec = torch.cat([obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1).to(torch.float32)
    return train_step, (state, obs_vec, policy, make_opt(policy), g)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=4096, help='the global batch, over all ranks')
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--rollout', type=int, default=32)
    ap.add_argument('--cycles', type=int, default=40)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu: gloo ranks)')
    ap.add_argument('--reactive', action='store_true',
                    help='the reactive plane-form rollout: the env state stays in the kernel plane layout for the '
                         'whole rollout; the policy runs between launches on the plane features')
    args = ap.parse_args(argv)

    mesh = sharding.make_mesh(args.device)
    n, r = mesh.size(), mesh.get_local_rank()
    if args.batch % n:
        raise SystemExit(f'--batch {args.batch} does not split into {n} equal shards')
    train_step, runner = build(args, mesh)
    path = 'reactive plane-form rollout' if args.reactive else 'fused sharded rollout'
    sync = torch.cuda.synchronize if sharding.mesh_device(mesh).type == 'cuda' else (lambda: None)

    runner, metrics = train_step(runner)  # warm-up
    sync()
    t0 = time.perf_counter()
    for i in range(args.iters):
        runner, metrics = train_step(runner)
        if i % 10 == 0 or i == args.iters - 1:
            sync()
            sps = args.batch * args.rollout * (i + 1) / (time.perf_counter() - t0)
            if r == 0:
                print(f'iter {i:4d}  reward {float(metrics["reward_mean"]):8.3f}  loss {float(metrics["loss"]):8.3f}  '
                      f'{sps:,.0f} env-steps/s over {n} rank(s), {path}', flush=True)
    sync()
    seconds = time.perf_counter() - t0
    policy = runner[1] if args.reactive else runner[2]
    return {'ranks': n, 'rank': r, 'batch': args.batch, 'iters': args.iters, 'path': path,
            'ms_per_iter': 1e3 * seconds / max(args.iters, 1),
            'env_steps_per_s': args.batch * args.rollout * args.iters / seconds if seconds > 0 else float('nan'),
            'metrics': {k: float(v) for k, v in metrics.items()}, 'policy': policy}


if __name__ == '__main__':
    main()
