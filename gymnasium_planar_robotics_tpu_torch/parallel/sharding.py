"""Env batches split over processes, one rank per device.

Counterpart of ``gymnasium_planar_robotics_tpu/parallel/sharding.py``.  The
JAX package shards one global batch over a device mesh from a single
controller (``NamedSharding``, ``shard_map``).  PyTorch's idiom for data
parallelism is one process per device, so here every rank of a
``torch.distributed`` group holds its own equal slice of the batch, and a
mesh is a 1-D ``DeviceMesh`` whose dimension is named ``'data'``.  Every
physics, collision and reward operation is per env, so a sharded step or
rollout runs the single-device fused function on the local shard with no
collective inside; only ``metrics_summary`` and the learner's gradients
(``models/ppo.py``) cross ranks.

Three names of the JAX module have no meaning here and are not ported:
``batch_sharding`` and ``replicated`` describe where one controller places a
global array, and each rank here simply holds its shard (parameters are
replicated by building them from the same seed on every rank); ``donate=``
lets XLA update the state in place, while the port's steps return new
tensors.

Randomness per rank: a seed given to a rollout or a step is offset by
``rank * SEED_STRIDE`` (on the card for a seed tensor: nothing is read back
to the host), as the JAX functions offset theirs by ``axis_index``; a
generator is split per rank by ``rank_generator`` (the counterpart of
``fold_in(key, axis_index)``).  At world size 1 the offset is 0 and the
generator is the caller's own, so every function here is bit-equal to its
unsharded twin.

No process group is made at import: ``make_mesh`` makes or joins one.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import os
import shutil
import struct
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
SEED_STRIDE = 1 << 20  # the seed offset between ranks (sharding.py:152, :191)


def _backend(device_type: str) -> str:
    return 'nccl' if device_type == 'cuda' else 'gloo'


def make_mesh(device=None, axis_name: str = DATA_AXIS):
    """A 1-D ``DeviceMesh`` over every rank of the default process group.

    ``device`` is the card unless named (``'cpu'``): NCCL on the card, gloo on
    the CPU.  The default group is used as it stands when one exists (e.g.
    one made by the caller); else, under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` in the environment), it is made from the environment;
    else a world-size-1 group is made on a ``FileStore`` in a temporary
    directory (no network, no port) and destroyed at exit.  On the card each
    rank takes the card ``LOCAL_RANK`` names."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device('cuda') if device is None else torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', device.index or 0)))
    if not dist.is_initialized():
        backend = _backend(device.type)
        if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
            dist.init_process_group(backend)
        else:
            tmp = tempfile.mkdtemp(prefix='gprt_store_')
            store = dist.FileStore(os.path.join(tmp, 'store'), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
            atexit.register(_close, tmp)
    elif _backend(device.type) not in dist.get_backend():
        raise ValueError(f'the default process group runs {dist.get_backend()}, which cannot reduce {device.type} '
                         'tensors')
    return init_device_mesh(device.type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def _close(tmp: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shard lives on."""
    return torch.device('cuda', torch.cuda.current_device()) if mesh.device_type == 'cuda' else torch.device('cpu')


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)})
    return tree


def shard_batch(tree: Any, mesh) -> Any:
    """This rank's equal slice of the leading (batch) axis of every tensor in
    ``tree`` (a tensor, a dict, a list or tuple, or a state dataclass), on
    this rank's device.  Raises unless the batch divides by the world size
    (``sharding.py:90``: equal shards)."""
    n, r, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)

    def take(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f'a batch of {b} does not split into {n} equal shards')
        k = b // n
        return x[r * k:(r + 1) * k].to(dev)

    return _map(tree, take)


def _local(x, dim: int, b: int, n: int, r: int):
    """``x`` as rank ``r``'s slice along ``dim`` (of ``n`` ranks): given for
    the global batch (``n * b`` long there), its ``b`` rows of this rank;
    given for the local shard already, as it is."""
    if x is None or not isinstance(x, torch.Tensor) or x.shape[dim] == b:
        return x
    if x.shape[dim] != n * b:
        raise ValueError(f'expected {b} (this shard) or {n * b} (the global batch) along dim {dim}, got '
                         f'{x.shape[dim]}')
    return x.narrow(dim, r * b, b).contiguous()


def offset_seed(seed, r: int):
    """``seed + r * SEED_STRIDE`` for rank ``r``: an int stays an int, a seed
    tensor (one int64 on the card) is offset on its device; rank 0 keeps the
    seed as it is."""
    off = r * SEED_STRIDE
    return seed if off == 0 or seed is None else seed + off


def _hash_seed(state: torch.Tensor, tag: int) -> int:
    digest = hashlib.blake2b(state.numpy().tobytes() + struct.pack('<q', tag), digest_size=8).digest()
    return int.from_bytes(digest, 'little') & (2**63 - 1)


def rank_generator(generator: torch.Generator | None, n: int, r: int, device) -> torch.Generator | None:
    """Rank ``r``'s generator (of ``n`` ranks), split from ``generator`` (the
    default generator of ``device`` when None) as ``fold_in(key,
    axis_index)`` splits a key.

    At world size 1 it is ``generator`` itself.  Above, each rank gets a new
    generator on the same device seeded from a hash of ``generator``'s state
    and the rank, and ``generator`` is then reseeded from a hash of its state
    alone, the same on every rank: the ranks' generators stay in step, and
    the next call splits new streams.  ``get_state`` of a card generator is
    host data, so nothing waits for the card."""
    if n == 1:
        return generator
    if generator is None:
        dev = torch.device(device)
        generator = (torch.cuda.default_generators[dev.index if dev.index is not None else torch.cuda.current_device()]
                     if dev.type == 'cuda' else torch.default_generator)
    state = generator.get_state()
    mine = torch.Generator(device=generator.device).manual_seed(_hash_seed(state, r))
    generator.manual_seed(_hash_seed(state, -1))
    return mine


def sharded_step_fn(config, params, mesh, step_fn: Callable) -> Callable:
    """The batched eager step ``step_fn(config, params, state, action,
    noise=None, generator=None)`` (e.g. ``planning.step_autoreset``) on this
    rank's shard: ``step(state, action, noise=None, generator=None) ->
    (state, obs, reward, terminated, truncated, info)``.  ``state`` is the
    local shard (``shard_batch``), ``action`` the local or the global batch;
    the step's draws come from ``rank_generator(generator)``."""
    n, r = mesh.size(), mesh.get_local_rank()

    def step(state, action, noise=None, generator=None):
        gen = rank_generator(generator, n, r, _device(state))
        return step_fn(config, params, state, _local(action, 0, _batch(state), n, r), noise=noise, generator=gen)

    return step


def _batch(state) -> int:
    return state.pos.shape[0]


def _device(state) -> torch.device:
    return state.pos.device


def make_sharded_fused_step(model, config, params, mesh, **fused_kw) -> Callable:
    """``model.make_fused_step_autoreset`` (kernel C, F or H) on this rank's
    shard, with no collective: ``step(state, action, noise=None, seed=None,
    generator=None) -> (state, obs, reward, terminated, truncated, info)``
    with ``.noise_planes``.

    ``state`` is this rank's shard; ``action`` the local or the global batch.
    Injected uniforms ``noise`` are ``[noise_planes, B]`` for the global
    batch (or the local one) and each rank takes its columns, as
    ``P(None, 'data')`` shards them (``sharding.py:109``): the gathered
    result is then the unsharded step's on the global batch, bit for bit.
    Without them, a given ``seed`` is offset by the rank and a generator is
    split by ``rank_generator``; nothing waits for the card."""
    fused = model.make_fused_step_autoreset(config, params, **fused_kw)
    n, r = mesh.size(), mesh.get_local_rank()

    def step(state, action, noise=None, seed=None, generator=None):
        b = _batch(state)
        action = _local(action, 0, b, n, r)
        if noise is not None:
            return fused(state, action, noise=_local(noise, 1, b, n, r))
        if seed is not None:
            return fused(state, action, seed=offset_seed(seed, r), generator=generator)
        return fused(state, action, generator=rank_generator(generator, n, r, _device(state)))

    step.noise_planes = fused.noise_planes
    return step


def make_sharded_fused_rollout(model, config, params, mesh, **fused_kw) -> Callable:
    """``model.make_fused_rollout`` (kernels C/D, F/G or H) on this rank's
    shard: ``rollout(state, actions [T, B, ...], seed) -> (final state,
    rewards [T, B], terminated [T, B], truncated [T, B])`` over the local
    ``B``.  ``actions`` may be given for the global batch (each rank takes its
    columns); the seed (an int, or one int64 on the card) is offset by
    ``rank * SEED_STRIDE`` (``sharding.py:152``)."""
    roll = model.make_fused_rollout(config, params, **fused_kw)
    n, r = mesh.size(), mesh.get_local_rank()

    def rollout(state, actions, seed):
        return roll(state, _local(actions, 1, _batch(state), n, r), offset_seed(seed, r))

    return rollout


def make_sharded_reactive_rollout(model, config, params, policy_step, num_steps: int, mesh, **kw) -> Callable:
    """``model.make_reactive_rollout`` (kernel C-feat, or F for planning) on
    this rank's shard: ``rollout(state, pol, generator, seed, policy_xs=None)
    -> (final state, traj, last_obs_vec)`` over the local batch.  The policy
    ``pol`` is the same on every rank (classic data parallelism; gradients
    are reduced in the learner).  The seed is offset by the rank, the policy
    draws from ``rank_generator(generator)`` (``fold_in(key, axis_index)``,
    ``sharding.py:191``), and ``policy_xs`` (batch last, e.g. PPO's
    exploration noise ``[T, A, B]``) may be given for the global batch."""
    roll = model.make_reactive_rollout(config, params, policy_step, num_steps, **kw)
    n, r = mesh.size(), mesh.get_local_rank()

    def rollout(state, pol, generator, seed, policy_xs=None):
        gen = generator if policy_xs is not None else rank_generator(generator, n, r, _device(state))
        return roll(state, pol, gen, offset_seed(seed, r), policy_xs=_local(policy_xs, -1, _batch(state), n, r))

    return rollout


def all_reduce_mean(values: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over ranks of ``values`` (equal shards: the global mean of
    per-shard means), in one ``all_reduce`` of their sum; returns a new
    tensor on the same device, with no host read.  At world size 1 the sum
    of one is the tensor itself, bit for bit."""
    out = values.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return out / mesh.size()


def metrics_summary(reward: torch.Tensor, terminated: torch.Tensor, info: dict, mesh=None) -> dict[str, torch.Tensor]:
    """Global scalar metrics (``sharding.py:225-239``) from this rank's
    per-env results: the local means, stacked, averaged over the ranks in
    one ``all_reduce`` (no collective without a mesh).  0-dim tensors on the
    results' device; nothing is read back to the host."""
    names = ('reward_mean', 'terminated_rate', 'success_rate', 'mover_collision_rate', 'wall_collision_rate')
    local = torch.stack([reward.to(torch.float32).mean()] + [
        x.to(torch.float32).mean() for x in (terminated, info['is_success'], info['mover_collision'],
                                             info['wall_collision'])])
    vals = local if mesh is None else all_reduce_mean(local, mesh)
    return dict(zip(names, vals.unbind()))
