"""One rank of the sharding tests: joins a gloo group on a ``FileStore``,
runs ``torch_sharding_cases.run_rank`` (``vector``:
``torch_vector_mesh_cases.run_rank``; ``example``: the sharded PPO example)
on its shard and writes its outputs to ``<mode>_rank<r>.npz``.  Imports torch, numpy and
the port only; the JAX half stays in the pytest process.

    python tests/torch_sharding_worker.py RANK WORLD DIR [cases | vector | example]
"""

import contextlib
import datetime
import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_sharding_cases as cases  # noqa: E402

from gymnasium_planar_robotics_tpu_torch.parallel import sharding  # noqa: E402


def main():
    rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else 'cases'
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, f'store_{mode}'), world)
    dist.init_process_group('gloo', store=store, rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        if mode == 'example':
            from gymnasium_planar_robotics_tpu_torch.examples import train_sharded

            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                res = train_sharded.main(['--batch', '256', '--iters', '2', '--rollout', '2', '--cycles', '3',
                                          '--device', 'cpu'])
            params = torch.cat([p.detach().reshape(-1) for p in res['policy'].parameters()]).numpy()
            out = {'log': np.frombuffer(log.getvalue().encode() or b' ', dtype=np.uint8), 'params': params,
                   'ranks': np.asarray(res['ranks'])}
        else:
            mesh = sharding.make_mesh('cpu')
            with np.load(os.path.join(out_dir, 'inputs.npz')) as z:
                inputs = dict(z)
            if mode == 'vector':
                import torch_vector_mesh_cases as vector_cases

                out = vector_cases.run_rank(mesh, inputs, world)
            else:
                out = cases.run_rank(mesh, inputs, world)
        np.savez(os.path.join(out_dir, f'{mode}_rank{rank}.npz'), **out)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
