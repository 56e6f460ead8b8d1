"""The rank side of the mesh vector env tests (``test_torch_vector_env_mesh.py``).

``run_rank`` runs on every rank of a gloo group (``torch_sharding_worker.py
RANK WORLD DIR vector``) the scenario that ``inputs.npz`` names:

- ``world1``: the vector envs over a world-size-1 mesh against the
  unsharded envs from the same seed, eager and with the fused step (its
  plain version: ``runner.fused_covers`` patched), over a reset and
  ``T_WORLD1`` steps, bit for bit; each step's collectives and its
  outputs' dtypes;
- ``jax``: the envs over the mesh from the JAX vector env's reset state
  (``std_noise=0``, all-zero uniforms as interpret mode's hardware bits),
  stepped with given actions through the fused step: every rank's gathered
  outputs and its state shard, each step's collectives and its outputs'
  dtypes;
- ``restarts``: envs with wall hits and truncation restarts; each rank's
  rows of the gathered outputs and its state against the unsharded step on
  its shard, under the generator ``sharding.rank_generator`` splits off for
  each call, bit for bit.

Imports numpy, torch, gymnasium and the port only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch_sharding_cases as cases

from gymnasium_planar_robotics_tpu_torch.envs import runner as env_runner
from gymnasium_planar_robotics_tpu_torch.envs import vector_env as tvec
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.parallel import sharding

B_JAX = 16  # the JAX comparison's global batch (2 x 8, 4 x 4)
T_JAX = 3
T_WORLD1 = 5
B_RESTART, T_RESTART = 32, 6
KW = dict(num_cycles=4)
FAMILIES = {'planning_m1': tplan, 'pushing': tpush}


def make_vec(family: str, b: int, mesh, **kw):
    if family == 'planning_m1':
        return tvec.PlanningVectorEnv(b, num_movers=1, mesh=mesh, device='cpu', **KW, **kw)
    return tvec.PushingVectorEnv(b, mesh=mesh, device='cpu', **KW, **kw)


def flat(tree, prefix: str = '') -> dict:
    """Nested tuples and dicts of arrays as one flat dict (``0.observation``,
    ``4.final_observation.achieved_goal``, ...)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, f'{prefix}.{k}' if prefix else str(k)))
    return out


def state_arrays(state) -> dict:
    return {f.name: getattr(state, f.name).detach().cpu().numpy() for f in dataclasses.fields(state)}


class counting_collectives:
    """Counts the runner's collectives (``runner.all_gather_flat``) in
    ``calls``."""

    def __enter__(self):
        self.saved, self.calls = env_runner.all_gather_flat, 0

        def count(*args, **kw):
            self.calls += 1
            return self.saved(*args, **kw)

        env_runner.all_gather_flat = count
        return self

    def __exit__(self, *exc):
        env_runner.all_gather_flat = self.saved


def collectives_and_dtypes(step) -> tuple[int, int, object]:
    """(collectives, distinct dtypes of the outputs, outputs) of ``step()``."""
    with counting_collectives() as c:
        out = step()
    return c.calls, len({v.dtype for v in flat(out).values()}), out


class fused_on_cpu:
    """``runner.fused_covers`` answering ``on`` (the fused step's plain
    version on the CPU) while the envs are made."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = env_runner.fused_covers
        env_runner.fused_covers = lambda config, params: self.on

    def __exit__(self, *exc):
        env_runner.fused_covers = self.saved


def world1(mesh) -> dict:
    out = {}
    rng = np.random.default_rng(11)
    for family in FAMILIES:
        for fused in (False, True):
            with fused_on_cpu(fused):
                envs = [make_vec(family, 24, m) for m in (mesh, None)]
            assert all(e.using_fused == fused for e in envs)
            runs = [[e.reset(seed=5)] for e in envs]
            counts = []
            for _ in range(T_WORLD1):
                a = rng.uniform(-8.0, 8.0, (24, 2))
                *count, res = collectives_and_dtypes(lambda: envs[0].step(a))
                runs[0].append(res)
                runs[1].append(envs[1].step(a))
                counts.append(count)
            got, want = (flat(run) for run in runs)
            states = [state_arrays(e.device_state) for e in envs]
            equal = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
            equal &= all(np.array_equal(states[0][k], states[1][k]) for k in states[1])
            ends = sum(int(r[2].sum() + r[3].sum()) for r in runs[0][1:])
            out[f'{family}/fused{int(fused)}/equal'] = np.asarray(equal)
            out[f'{family}/fused{int(fused)}/ends'] = np.asarray(ends)
            out[f'{family}/fused{int(fused)}/collectives'] = np.asarray(counts)
    return out


def jax_parity(mesh, inputs: dict) -> dict:
    """The fused step over the mesh from the JAX env's state; all-zero
    uniforms (``kernels.draw_uniforms``) as interpret mode draws."""
    out = {}
    saved = kernels.draw_uniforms
    kernels.draw_uniforms = cases.zero_uniforms
    try:
        for family, model in FAMILIES.items():
            with fused_on_cpu(True):
                env = make_vec(family, B_JAX, mesh, std_noise=0.0)
            env.reset(seed=0)
            d = {k[len(family) + 7:]: v for k, v in inputs.items() if k.startswith(f'{family}/state.')}
            env._runner.state = sharding.shard_batch(model.state_from_numpy(d, device='cpu'), mesh)
            counts = []
            for t, a in enumerate(inputs[f'{family}/actions']):
                *count, res = collectives_and_dtypes(lambda: env.step(a))
                counts.append(count)
                out.update({f'{family}/t{t}/{k}': v for k, v in flat(res).items()})
            out[f'collectives/{family}'] = np.asarray(counts)  # outside the family's outputs
            out.update({f'{family}/state.{k}': v for k, v in state_arrays(env.device_state).items()})
    finally:
        kernels.draw_uniforms = saved
    return out


def restarts(mesh) -> dict:
    """Each rank's shard against the unsharded step on it, with the
    generator the runner splits off for each call."""
    out = {}
    n, r = mesh.size(), mesh.get_local_rank()
    b = B_RESTART // n
    rng = np.random.default_rng(13)
    for family, model in FAMILIES.items():
        for fused in (False, True):
            with fused_on_cpu(fused):
                env = make_vec(family, B_RESTART, mesh)
            cfg, prm = env.config, env.params
            planted = cases.episode_state(family, cfg, prm, B_RESTART, seed=2)
            g = torch.Generator().manual_seed(8)
            env.reset(seed=8)
            model.init_batch(cfg, prm, b, sharding.rank_generator(g, n, r, 'cpu'))  # the reset's draws
            env._runner.state = state = sharding.shard_batch(planted, mesh)
            step = (model.make_fused_step_autoreset(cfg, prm) if fused else
                    lambda s, a, generator: model.step_autoreset(cfg, prm, s, a, generator=generator))
            equal, ends = True, 0
            for _ in range(T_RESTART):
                a = rng.uniform(-8.0, 8.0, (B_RESTART, 2)).astype(np.float32)
                got = env.step(a)
                state, *want = step(state, torch.from_numpy(a[r * b:(r + 1) * b]).to(prm.min_xy.dtype),
                                    generator=sharding.rank_generator(g, n, r, 'cpu'))
                got_rows = {k: v[r * b:(r + 1) * b] for k, v in flat(got).items()}
                want_flat = flat(tuple(want))
                equal &= got_rows.keys() == want_flat.keys() and all(
                    np.array_equal(got_rows[k], want_flat[k]) for k in want_flat)
                equal &= all(np.array_equal(x, y) for x, y in zip(state_arrays(env.device_state).values(),
                                                                   state_arrays(state).values()))
                ends += int(got[2][r * b:(r + 1) * b].sum() + got[3][r * b:(r + 1) * b].sum())
            out[f'{family}/fused{int(fused)}/equal'] = np.asarray(equal)
            out[f'{family}/fused{int(fused)}/ends'] = np.asarray(ends)
            out[f'{family}/fused{int(fused)}/obs'] = flat(got)['0.observation']
    return out


def run_rank(mesh, inputs: dict, world: int) -> dict:
    scenario = str(inputs['scenario'])
    if scenario == 'world1':
        return world1(mesh)
    if scenario == 'jax':
        return jax_parity(mesh, inputs)
    return restarts(mesh)
