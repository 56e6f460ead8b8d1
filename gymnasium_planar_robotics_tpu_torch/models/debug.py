"""Debug-mode invariant checks on a step (the reference's loud asserts).

Counterpart of ``gymnasium_planar_robotics_tpu/models/debug.py``.  The
reference asserts at run time, e.g. that a mover is above some tile
(``basic_envs.py:514-517``); the batched steps report such states instead of
raising, and the JAX package restores the loud form with ``checkify``.
PyTorch has no ``checkify``: here every invariant is reduced to a boolean
on the step's device inside ``checked``, with nothing read back to the host,
and ``err.get()`` (one read) names the first one violated, ``err.throw()``
raises with it.  The messages are the JAX package's, word for word.
"""

from __future__ import annotations

from typing import Callable

import torch


class InvariantError(RuntimeError):
    """A violated invariant of a checked step."""


class CheckErrors:
    """The invariants of one checked call: booleans on the device, True
    where the invariant holds, each with its message."""

    def __init__(self):
        self._preds: list[torch.Tensor] = []
        self._msgs: list[str] = []

    def check(self, pred, msg: str) -> None:
        """Record ``pred`` (a boolean tensor, reduced with ``all``) as an
        invariant with message ``msg``; nothing is read back here."""
        self._preds.append(torch.as_tensor(pred).all())
        self._msgs.append(msg)

    def get(self) -> str | None:
        """The first violated invariant's message (as ``checkify``'s
        ``err.get()`` words it), or None: one read from the device."""
        if not self._preds:
            return None
        ok = torch.stack(self._preds).cpu()
        bad = (~ok).nonzero()
        return None if bad.numel() == 0 else f'{self._msgs[int(bad[0, 0])]} (`check` failed)'

    def throw(self) -> None:
        """Raise ``InvariantError`` with the first violated message, if any."""
        msg = self.get()
        if msg is not None:
            raise InvariantError(msg)


def _default_invariants(config, params, state, out, check: Callable) -> None:
    new_state, obs, reward, terminated, truncated, info = out
    pos, vel = new_state.pos, new_state.vel
    check(torch.isfinite(pos).all(), 'non-finite mover position')
    check(torch.isfinite(vel).all(), 'non-finite mover velocity')
    # the clamp chain keeps |v| <= v_max (+ the sensor noise's slack)
    vmax = params.v_max + 10.0 * params.std_noise[1] + 1e-6
    speed = torch.linalg.vector_norm(vel.reshape(-1, 2), dim=-1)
    check((speed <= vmax).all(), 'velocity clamp violated')
    # the reference's "mover must be above a tile" assert: outside the
    # grid's bounding box means a wall termination was missed upstream
    hi = params.grid.max_xy
    xy = pos.reshape(-1, 2)
    c = params.c_size.max()
    on_table = ((xy >= -c) & (xy <= hi + c)).all()
    check(on_table | terminated.any(), 'mover left the table without termination')


def make_checked_step(config, params, step_fn: Callable, extra_invariants: Callable | None = None):
    """Wrap ``step_fn(config, params, state, action)`` with the invariant
    checks.  Returns ``checked(state, action) -> (err, (state, obs, reward,
    terminated, truncated, info))``; ``err.throw()`` raises on a violation.
    ``extra_invariants(config, params, state, out, check)`` adds checks
    through ``check(pred, msg)``."""

    def checked(state, action):
        err = CheckErrors()
        out = step_fn(config, params, state, action)
        _default_invariants(config, params, state, out, err.check)
        if extra_invariants is not None:
            extra_invariants(config, params, state, out, err.check)
        return err, out

    return checked
