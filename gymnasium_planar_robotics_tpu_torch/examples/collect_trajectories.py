"""Collect rollout batches into the native trajectory store.

Counterpart of the JAX package's ``examples/collect_trajectories.py``::

    python -m gymnasium_planar_robotics_tpu_torch.examples.collect_trajectories --out traj --steps 200 \\
        [--batch 512] [--device cpu]

Each frame is one batched transition (action, reward, done; on the CPU also
the observation).  On the card the actions are drawn ahead in chunks of 64
steps and each chunk runs through planning's fused rollout (kernel F, one
launch a step); on the CPU the eager batched step runs, as the JAX example
does off its accelerator.  The C++ writer (``utils/trajstore``) appends on a
background thread, so the device loop does not wait for the disk.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, planning
from gymnasium_planar_robotics_tpu_torch.utils import trajstore


def collect(out: str, batch: int, steps: int, device=None, keep: list | None = None) -> int:
    """Write ``steps`` frames of ``batch`` envs to the store at ``out``; the
    frames written.  ``keep``, when given, receives each frame's bytes as
    appended, for a read-back check."""
    dev = common.resolve_device(device)
    config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    state, obs, _ = planning.init_batch(config, params, batch, g)
    on_card = dev.type == 'cuda'
    chunk = min(64, steps)
    if on_card:
        roll = planning.make_fused_rollout(config, params)
    g_act = torch.Generator(device=dev).manual_seed(1)
    written, seed = 0, 0
    with trajstore.TrajWriter(out) as w:
        while written < steps:
            n = min(chunk, steps - written)
            actions = -10.0 + 20.0 * torch.rand((n, batch, 2), generator=g_act, device=dev)
            if on_card:
                state, rewards, terms, truncs = roll(state, actions, seed)
                seed += n
                frames = [{'action': actions[t], 'reward': rewards[t], 'done': terms[t] | truncs[t]} for t in range(n)]
            else:
                frames = []
                for t in range(n):
                    state, obs, reward, term, trunc, info = planning.step_autoreset(config, params, state, actions[t],
                                                                                    generator=g)
                    frames.append({'obs': obs, 'action': actions[t], 'reward': reward, 'done': term | trunc})
            for frame in frames:
                data = trajstore.pack_pytree(frame)
                w.append(data)
                if keep is not None:
                    keep.append(data)
            written += n
    # after close(): the writer appends on its thread, so its count is whole
    # only once it has drained
    return w.frames_written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default='planar_traj')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args(argv)
    frames = collect(args.out, args.batch, args.steps, args.device)
    print(f'wrote {frames} frames to {args.out} (native writer)')
    with trajstore.TrajReader(args.out) as r:
        print(f'readable frames: {len(r)}; frame 0 leaves: {len(r.get_arrays(0))}')
    return frames


if __name__ == '__main__':
    main()
