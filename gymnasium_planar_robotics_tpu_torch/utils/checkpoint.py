"""Checkpoint and resume for env state and learner trees, in PyTorch.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/checkpoint.py``: the
whole simulation is tensors (env state batches, generators, learner weights,
optimizer state), so an exact resume is a save and restore of arrays.  A
tree is any nesting of dicts, lists and tuples over tensors, Python scalars,
strings and None, and these objects, which are saved by their state and
restored into the object of the same place in the template:

- a dataclass (``PushingState``, ``PlanningState``): its fields;
- an ``nn.Module`` or a ``torch.optim.Optimizer``: its ``state_dict`` (for
  Adam, the moments and step counts);
- a ``torch.Generator``: its state.

The tree of states goes to one ``torch.save`` file, bit for bit (each
tensor keeps its dtype), read back with ``weights_only=True``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
from torch import nn

FILE = 'checkpoint.pt'


def _state(obj):
    """``obj`` with every module, optimizer, generator and dataclass in it
    replaced by its state."""
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        return obj.state_dict()
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _state(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_state(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f'cannot checkpoint a {type(obj).__name__}')


def _mismatch(path: str, what: str):
    return ValueError(f'checkpoint structure mismatch at {path or "the root"}: {what}')


def _load(saved, like, path: str = ''):
    """``saved`` (a tree of states) restored into the template ``like``."""
    if isinstance(like, (nn.Module, torch.optim.Optimizer)):
        like.load_state_dict(saved)
        return like
    if isinstance(like, torch.Generator):
        like.set_state(saved)
        return like
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.dtype != like.dtype or saved.shape != like.shape:
            raise _mismatch(path, f'saved {getattr(saved, "dtype", type(saved).__name__)} '
                                  f'{tuple(getattr(saved, "shape", ()))}, template {like.dtype} {tuple(like.shape)}')
        return saved.to(like.device)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = [f.name for f in dataclasses.fields(like)]
        if not isinstance(saved, dict) or list(saved) != names:
            raise _mismatch(path, f'template {type(like).__name__} has fields {names}')
        return dataclasses.replace(like, **{k: _load(saved[k], getattr(like, k), f'{path}.{k}') for k in names})
    if isinstance(like, dict):
        if not isinstance(saved, dict) or saved.keys() != like.keys():
            raise _mismatch(path, f'template keys {sorted(map(str, like))}')
        return {k: _load(saved[k], like[k], f'{path}[{k!r}]') for k in like}
    if isinstance(like, (list, tuple)):
        if type(saved) is not type(like) or len(saved) != len(like):
            raise _mismatch(path, f'template {type(like).__name__} of {len(like)} items')
        return type(like)(_load(s, x, f'{path}[{i}]') for i, (s, x) in enumerate(zip(saved, like)))
    return saved


def save(directory: str | Path, tree, step: int | None = None) -> None:
    """Save ``tree`` (see the module docstring); an exact, bit-preserving
    round trip."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save({'step': step, 'tree': _state(tree)}, directory / FILE)


def restore(directory: str | Path, like):
    """The saved tree, restored into the structure of ``like`` (e.g. a
    freshly built runner): tensors on the devices of ``like``'s, modules,
    optimizers and generators loaded in place, dataclasses replaced.
    Raises ``ValueError`` where the structures differ."""
    saved = torch.load(Path(directory) / FILE, map_location='cpu', weights_only=True)
    return _load(saved['tree'], like)


def saved_step(directory: str | Path) -> int | None:
    """The step recorded in a checkpoint directory, if any."""
    return torch.load(Path(directory) / FILE, map_location='cpu', weights_only=True, mmap=True)['step']
