"""Mover dynamics of the eager steps: the clamp chain and MuJoCo's update.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/dynamics.py``: for the
reference's mover (free joint, no damping, gravity compensated, force
actuators on x and y) MuJoCo reduces to a planar double integrator with
semi-implicit Euler updates (``qacc = ctrl``, ``v += dt * qacc``, ``p += dt
* v``), and in jerk mode an integrator actuator updated before the force is
applied.  Batched over leading dimensions, the last one the (x, y) pair;
any float dtype.  The fused kernels' f32 chain is ``ops/kernels/dynamics``.

Every divisor and scalar may be a 0-dim tensor: dividing by one is IEEE
division on every device (PyTorch turns a Python-float divisor of a CUDA
tensor into a multiply by its reciprocal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, ``sqrt(sum(v * v))`` as
    ``jnp.linalg.norm`` forms it, correctly rounded."""
    return sqrt((v * v).sum(-1, keepdim=keepdim))


def ensure_max_dyn_val(current: torch.Tensor, max_value, next_deriv: torch.Tensor, dt):
    """Clamp ``current + dt * next_deriv`` to the L2 ball of ``max_value``
    (inclusive ``>=``), back-computing the derivative actually applied.
    Returns ``(next_value, next_deriv)``."""
    candidate = current + dt * next_deriv
    n = norm(candidate, keepdim=True)
    clamp = n >= max_value
    safe_norm = torch.where(n > 0, n, 1.0)
    next_value = torch.where(clamp, max_value * candidate / safe_norm, candidate)
    return next_value, torch.where(clamp, (next_value - current) / dt, next_deriv)


class CycleResult(NamedTuple):
    pos: torch.Tensor  # [..., 2]
    vel: torch.Tensor
    acc: torch.Tensor  # acceleration applied this cycle (MuJoCo qacc)
    act: torch.Tensor  # actuator activation (jerk mode; zeros otherwise)


def acceleration_cycle(pos, vel, vel_measured, action, v_max, dt, accel_scale=1.0) -> CycleResult:
    """One 1 ms control cycle in acceleration mode: the velocity clamp on the
    (noisy) reading ``vel_measured``; ``accel_scale`` is gain mass over body
    mass (1 without a bumper, which multiplies exactly)."""
    _, acc_cmd = ensure_max_dyn_val(vel_measured, v_max, action, dt)
    qacc = accel_scale * acc_cmd
    new_vel = vel + dt * qacc
    return CycleResult(pos + dt * new_vel, new_vel, qacc, torch.zeros_like(acc_cmd))


def jerk_cycle(pos, vel, act, vel_measured, action, v_max, a_max, dt, accel_scale=1.0) -> CycleResult:
    """One 1 ms control cycle in jerk mode: bound the candidate acceleration
    to ``a_max``, then the resulting velocity to ``v_max``; where the velocity
    clamp changed the acceleration, the jerk is re-derived from it.  The
    integrator state then moves by ``dt * jerk`` and the body accelerates at
    ``accel_scale * act``."""
    acc_meas = accel_scale * act
    acc_tmp, jerk_1 = ensure_max_dyn_val(acc_meas, a_max, action, dt)
    _, acc_final = ensure_max_dyn_val(vel_measured, v_max, acc_tmp, dt)
    vel_clamped = (acc_final != acc_tmp).any(-1, keepdim=True)
    jerk_ctrl = torch.where(vel_clamped, (acc_final - acc_meas) / dt, jerk_1)
    new_act = act + dt * jerk_ctrl
    qacc = accel_scale * new_act
    new_vel = vel + dt * qacc
    return CycleResult(pos + dt * new_vel, new_vel, qacc, new_act)
