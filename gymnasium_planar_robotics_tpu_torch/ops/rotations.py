"""Quaternion helpers in PyTorch (the two the reset's box pair test needs).

Counterpart of ``gymnasium_planar_robotics_tpu/ops/rotations.py``
(``quat2mat``, ``unit_vector``): quaternions are (w, x, y, z), everything is
batched over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt

_FLOAT_EPS = float(np.finfo(np.float64).eps)


def unit_vector(data: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``data`` divided by its Euclidean norm along ``dim``."""
    return data / sqrt((data * data).sum(dim, keepdim=True))


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` of quaternions ``[..., 4]``; the
    identity where the squared norm is not above float64 epsilon."""
    w, x, y, z = quat.unbind(-1)
    nq = (quat * quat).sum(-1)
    s = 2.0 / torch.where(nq > _FLOAT_EPS, nq, 1.0)
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    row0 = torch.stack([1.0 - (yY + zZ), xY - wZ, xZ + wY], -1)
    row1 = torch.stack([xY + wZ, 1.0 - (xX + zZ), yZ - wX], -1)
    row2 = torch.stack([xZ - wY, yZ + wX, 1.0 - (xX + yY)], -1)
    mat = torch.stack([row0, row1, row2], -2)
    eye = torch.eye(3, dtype=mat.dtype, device=mat.device).expand(mat.shape)
    return torch.where((nq > _FLOAT_EPS)[..., None, None], mat, eye)
