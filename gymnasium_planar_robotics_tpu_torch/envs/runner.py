"""The card-facing half of the Gymnasium, vector and PettingZoo adapters.

Counterpart of what ``gymnasium_planar_robotics_tpu/envs/gym_env.py``,
``vector_env.py`` and ``pettingzoo_env.py`` hand to ``jax.jit`` and
``jax.device_get``: the (config, params, state) triple, the generator the
steps draw from, the step chosen for the configuration, and one transfer of
a step's outputs to the host.  It imports ``torch`` and ``numpy`` only (no
``gymnasium``, ``pettingzoo`` or ``mujoco``), so the Gymnasium shells in
this package wrap it where those are installed and ``chip_smoke.py`` drives
it where they are not.

- ``EnvRunner``: one env (B = 1) over the eager ``step`` /
  ``step_with_cycles`` / ``reset`` of its family, with the reset overrides.
  On the card the observation noise goes through kernel A.
- ``VectorRunner``: B envs over the fused autoreset step where a kernel
  covers the configuration (``fused_covers``: on the card, f32, for pushing
  the sparse reward, for planning at most ``planning_multi.MAX_MOVERS``
  movers): kernel C (C box) for pushing, F for one mover, H for more; the
  eager ``step_autoreset`` elsewhere, as the JAX package takes its vmapped
  XLA step where no Pallas kernel applies.  A fused step that fails to
  build or launch raises; nothing falls back to the eager step.
- Over a mesh (``mesh=``, from ``parallel/sharding.make_mesh``: one rank a
  device) ``VectorRunner`` holds this rank's shard of the global batch and
  steps it with ``sharding.make_sharded_fused_step`` (or
  ``sharding.sharded_step_fn`` over the eager step), its draws from
  ``sharding.rank_generator``'s split; every rank returns the global batch's
  outputs, gathered by ``BatchGather`` (one collective a call), as the
  JAX package's vector env hands its one process the whole batch.
- ``HostCopy``: a step's outputs, every leaf copied with
  ``non_blocking=True`` into pinned host buffers and one wait on one event:
  one host synchronisation a step (``host_syncs`` counts them), the port's
  counterpart of the one ``jax.device_get`` a step.  The action goes the
  other way through a pinned buffer too, so the step itself waits on
  nothing.

Both runners take the family's module (``models.pushing`` or
``models.planning``) and its (config, params); the tensors' device is the
params' (the card unless the caller built them with ``device='cpu'``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gymnasium_planar_robotics_tpu_torch.models import planning, pushing
from gymnasium_planar_robotics_tpu_torch.ops.kernels.planning_multi import MAX_MOVERS
from gymnasium_planar_robotics_tpu_torch.parallel import sharding


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree, out: list) -> list:
    """The leaves of nested dicts, tuples and lists, appended to ``out``."""
    if isinstance(tree, dict):
        for v in tree.values():
            leaves(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            leaves(v, out)
    else:
        out.append(tree)
    return out


class HostCopy:
    """Moves a step's inputs to its device and its outputs to the host.

    On the card every output leaf is copied with ``non_blocking=True`` into
    a pinned host buffer kept for its (position, shape, dtype), then one
    event recorded after the copies is waited on: one host synchronisation
    a call of ``fetch``.  The buffers are reused, so ``fetch`` returns numpy
    copies of them.  On the CPU the leaves are the arrays.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.host_syncs = 0
        self._out: dict = {}
        self._in: dict = {}
        self._event = torch.cuda.Event() if self.cuda else None

    def to_device(self, array, dtype: torch.dtype, key=0) -> torch.Tensor:
        """A host array (numpy or nested lists) as a tensor of ``dtype`` on
        the device, through a pinned staging buffer on the card."""
        host = torch.as_tensor(array).to(dtype)
        if not self.cuda:
            return host.clone()
        buf = self._in.get(key)
        if buf is None or buf.shape != host.shape:
            buf = self._in[key] = torch.empty(host.shape, dtype=dtype, pin_memory=True)
        # the previous call's copy out of this buffer ended before its
        # fetch returned (the event follows it on the stream)
        buf.copy_(host)
        return buf.to(self.device, non_blocking=True)

    def fetch(self, tree):
        """The tree with every tensor leaf as a numpy array on the host."""
        if not self.cuda:
            return tree_map(lambda t: t.detach().numpy().copy() if isinstance(t, torch.Tensor) else t, tree)
        hosts = {}
        for i, t in enumerate(t for t in leaves(tree, []) if isinstance(t, torch.Tensor)):
            key = (i, tuple(t.shape), t.dtype)
            buf = self._out.get(key)
            if buf is None:
                buf = self._out[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            hosts[id(t)] = buf
        self._event.record()
        self._event.synchronize()
        self.host_syncs += 1
        return tree_map(lambda t: hosts[id(t)].numpy().copy() if isinstance(t, torch.Tensor) else t, tree)


def family_of(config) -> object:
    """The family module of a config: ``models.planning`` or
    ``models.pushing``."""
    return planning if isinstance(config, planning.PlanningConfig) else pushing


class EnvRunner:
    """One env (B = 1) of a family on the eager step.

    ``reset(**overrides)`` and ``step(action)`` return host numpy trees
    without the batch axis; the state stays on the device (``state``).  The
    generator lives on the params' device; ``seed`` reseeds it, and resets
    without a seed continue its stream."""

    def __init__(self, config, params):
        self.model = family_of(config)
        self.config, self.params = config, params
        self.device = params.min_xy.device
        self.dtype = params.min_xy.dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.seed()
        self.host = HostCopy(self.device)
        self.state = None
        self.steps = 0

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(int(seed))

    def reset(self, **overrides):
        """``model.reset`` of one env with the family's overrides (planning
        ``start_xy`` / ``goals_xy``, pushing ``mover_start_xy_pos`` /
        ``object_goal_xy_pos``): (obs, info)."""
        kw = {k: None if v is None else self.host.to_device(v, self.dtype, k) for k, v in overrides.items()}
        self.state, obs, info = self.model.reset(self.config, self.params, 1, self.generator, **kw)
        self.steps = 0
        return self._unbatch(self.host.fetch((obs, info)))

    def step(self, action, with_cycles: bool = False):
        """One eager step: (obs, reward, terminated, truncated, info), and
        with ``with_cycles`` the per-cycle stacks of ``step_with_cycles``
        last.  The new step counter comes in the same transfer
        (``steps``)."""
        a = self.host.to_device(action, self.dtype, 'action').reshape(1, -1)
        fn = self.model.step_with_cycles if with_cycles else self.model.step
        self.state, *out = fn(self.config, self.params, self.state, a, generator=self.generator)
        *out, steps = self._unbatch(self.host.fetch((*out, self.state.steps)))
        self.steps = int(steps)
        return tuple(out)

    @staticmethod
    def _unbatch(tree):
        return tree_map(lambda a: a[0], tree)


def fused_covers(config, params) -> bool:
    """Whether a fused autoreset kernel steps this configuration: on the
    card, f32 params, for pushing the sparse reward (kernel C, C box), for
    planning the circle or box shape and at most ``MAX_MOVERS`` movers
    (kernel F for one, H for more)."""
    if params.min_xy.device.type != 'cuda' or params.v_max.dtype != torch.float32:
        return False
    if family_of(config) is pushing:
        return config.reward_mode == 'sparse'
    return config.collision_shape in ('circle', 'box') and config.num_movers <= MAX_MOVERS


def all_gather_flat(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    """``flat`` of every rank of ``group`` into ``out`` (``[world * n]``,
    rank order): one collective."""
    # all_gather_into_tensor, renamed all_gather_single in torch 2.13
    gather = getattr(dist, 'all_gather_single', None) or dist.all_gather_into_tensor
    gather(out, flat, group=group)


class BatchGather:
    """Every tensor leaf of a tree (this rank's shard, batch first) as the
    global batch, the ranks' shards in rank order.

    The leaves travel as bytes, the widest dtypes first (so each starts at
    a multiple of its element size): packed into one send buffer and
    gathered with one collective into one receive buffer ``[world, n]``,
    both kept for the tree's layout.  A global leaf is a view of its
    columns of the receive buffer (at world size 1 no copy; above it one
    copy puts the ranks' rows in batch order), valid until the next call
    with the same layout."""

    def __init__(self, mesh):
        self.mesh, self.world = mesh, mesh.size()
        self._buffers: dict = {}

    def __call__(self, tree):
        order = sorted((t for t in leaves(tree, []) if isinstance(t, torch.Tensor)), key=lambda t: -t.element_size())
        key = tuple((tuple(t.shape), t.dtype) for t in order)
        sizes = [t.numel() * t.element_size() for t in order]
        if key not in self._buffers:
            send = torch.empty(sum(sizes), dtype=torch.uint8, device=order[0].device)
            self._buffers[key] = send, torch.empty(self.world * send.numel(), dtype=torch.uint8, device=send.device)
        send, recv = self._buffers[key]
        torch.cat([t.reshape(-1).view(torch.uint8) for t in order], out=send)
        all_gather_flat(recv, send, self.mesh.get_group())
        full = {}
        for t, col in zip(order, recv.view(self.world, -1).split(sizes, dim=1)):
            b = self.world * t.shape[0]
            full[id(t)] = col.reshape(b, -1).view(t.dtype).reshape(b, *t.shape[1:])
        return tree_map(lambda t: full[id(t)] if isinstance(t, torch.Tensor) else t, tree)


class VectorRunner:
    """``num_envs`` envs of a family with in-place autoreset (the
    pre-reset observation in ``info['final_observation']``).

    ``using_fused`` says whether the fused autoreset step runs (see
    ``fused_covers``); ``device_state`` is the state on the device, for
    learners that skip the numpy boundary.

    With ``mesh`` (``sharding.make_mesh``), ``num_envs`` is the global
    batch and must divide by ``mesh.size()``; this rank holds envs
    ``[rank * b, (rank + 1) * b)`` (``local_envs`` = b) in ``state`` and
    ``device_state``, resets them with ``init_batch`` and steps them with
    the sharded fused step (or the sharded eager step), drawing from
    ``sharding.rank_generator``'s split of ``generator``; ``reset`` and
    ``step`` return the global batch's outputs on every rank.  At world
    size 1 every output is the unsharded runner's, bit for bit."""

    def __init__(self, config, params, num_envs: int, mesh=None):
        self.model = family_of(config)
        self.config, self.params = config, params
        self.num_envs = int(num_envs)
        self.mesh = mesh
        self._gather = None if mesh is None else BatchGather(mesh)
        self.world, self.rank = (1, 0) if mesh is None else (mesh.size(), mesh.get_local_rank())
        if self.num_envs % self.world:
            raise ValueError(f'{self.num_envs} envs do not split into {self.world} equal shards (the JAX '
                             "package's vector env shards its batch with NamedSharding(mesh, P('data')), which "
                             'needs the same)')
        self.local_envs = self.num_envs // self.world
        self.device = params.min_xy.device
        if mesh is not None and self.device.type != mesh.device_type:
            raise ValueError(f'params on {self.device}, the mesh on {mesh.device_type}')
        self.dtype = params.min_xy.dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.seed()
        self.host = HostCopy(self.device)
        self.using_fused = fused_covers(config, params)
        if mesh is not None:
            self._step = (sharding.make_sharded_fused_step(self.model, config, params, mesh) if self.using_fused
                          else sharding.sharded_step_fn(config, params, mesh, self.model.step_autoreset))
        elif self.using_fused:
            self._step = self.model.make_fused_step_autoreset(config, params)
        else:
            def eager(state, action, generator):  # self.params as they stand at the call
                return self.model.step_autoreset(self.config, self.params, state, action, generator=generator)
            self._step = eager
        self.state = None

    @property
    def device_state(self):
        return self.state

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(int(seed))

    def _global(self, tree):
        return tree if self.mesh is None else self._gather(tree)

    def reset(self):
        """``init_batch`` of every env (of this rank's shard under a mesh):
        (obs, info) of the global batch on the host."""
        gen = sharding.rank_generator(self.generator, self.world, self.rank, self.device)
        self.state, obs, info = self.model.init_batch(self.config, self.params, self.local_envs, gen)
        return self.host.fetch(self._global((obs, info)))

    def step(self, actions):
        """One autoreset step of every env from host actions ``[B, A]`` of
        the global batch: (obs, reward, terminated, truncated, info) of the
        global batch on the host, the state (this rank's shard) kept on the
        device."""
        lo = self.rank * self.local_envs
        rows = torch.as_tensor(actions).reshape(self.num_envs, -1)[lo:lo + self.local_envs]
        a = self.host.to_device(rows, torch.float32 if self.using_fused else self.dtype, 'actions')
        # a sharded step splits the generator itself (``rank_generator``)
        self.state, *out = self._step(self.state, a, generator=self.generator)
        return self.host.fetch(self._global(tuple(out)))

    def env0(self):
        """Env 0 of the global batch (rank 0's first), a state of one env on
        every rank; under a mesh a collective every rank calls."""
        row = {f.name: getattr(self.state, f.name)[:1] for f in dataclasses.fields(self.state)}
        if self.mesh is not None:
            row = {k: v[:1] for k, v in self._gather(row).items()}
        return dataclasses.replace(self.state, **row)
