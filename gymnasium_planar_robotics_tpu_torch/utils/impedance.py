"""Task-space impedance control, as pure functions.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/impedance.py``, the
surface of the reference's ``MoverImpedanceController``: stiffness
diag(K_t, K_r), critical damping ``D = 2 sqrt(K m)``, the orientation error
as the axis-angle of ``R_cur^T R_des`` turned into the base frame, and the
wrench ``mask * (K e - D v)``.  A free joint's Jacobian is the identity, so
the controller is this direct law, batched over leading dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.ops import rotations


@dataclasses.dataclass(frozen=True)
class ImpedanceGains:
    """Stiffness and damping of the six DoFs (x, y, z, a, b, c)."""

    stiffness: torch.Tensor  # [6] diagonal of K
    damping: torch.Tensor  # [6] diagonal of D
    joint_mask: torch.Tensor  # [6] 0/1: the DoFs the controller drives


def make_gains(mover_mass: float, translational_stiffness=1.0, rotational_stiffness=0.1, joint_mask=None,
               dtype=torch.float64, device=None) -> ImpedanceGains:
    """Gains by the reference's critical-damping rule ``D = 2 sqrt(K m)``, on
    ``device`` (the card unless named)."""
    device = common.resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    kt = torch.as_tensor(translational_stiffness, **kw).expand(3)
    kr = torch.as_tensor(rotational_stiffness, **kw).expand(3)
    k = torch.cat([kt, kr])
    d = 2.0 * torch.sqrt(k * mover_mass)
    mask = torch.ones(6, **kw) if joint_mask is None else torch.as_tensor(joint_mask, **kw)
    return ImpedanceGains(stiffness=k, damping=d, joint_mask=mask)


def impedance_wrench(gains: ImpedanceGains, pos: torch.Tensor, quat: torch.Tensor, vel: torch.Tensor,
                     pos_d: torch.Tensor, quat_d: torch.Tensor,
                     ctrl_callback: Callable[[torch.Tensor], torch.Tensor] | None = None) -> torch.Tensor:
    """The wrench ``[..., 6] = mask * (K e - D v)`` from the position ``[...,
    3]``, orientation ``[..., 4]`` (w, x, y, z) and twist ``[..., 6]`` (v,
    omega) to the desired pose.  ``ctrl_callback(wrench) -> wrench`` is the
    reference's hook for force and torque limits."""
    mat = rotations.quat2mat(quat)
    mat_d = rotations.quat2mat(quat_d)
    pos_err = pos_d - pos
    # orientation error: the axis-angle of R_cur^T R_des, in the base frame
    rel = torch.matmul(mat.transpose(-1, -2), mat_d)
    axis, theta = rotations.quat2axisangle(rotations.mat2quat(rel))
    rot_err = torch.matmul(mat, (axis * theta[..., None])[..., None])[..., 0]
    err = torch.cat([pos_err, rot_err], -1)
    ctrl = gains.joint_mask * (gains.stiffness * err - gains.damping * vel)
    return ctrl if ctrl_callback is None else ctrl_callback(ctrl)
