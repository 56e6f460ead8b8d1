"""Batched rotation helpers in PyTorch.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/rotations.py``, function
for function: quaternions are (w, x, y, z), Euler angles relative 'xyz', as
in MuJoCo.  Every function is batched over leading dimensions and keeps the
dtype it is given (float64 in, float64 out); ``mat2quat`` is the
branch-free four-candidate construction, selected by the largest diagonal
combination.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt

_FLOAT_EPS = float(np.finfo(np.float64).eps)
_EPS4 = _FLOAT_EPS * 4.0


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def euler2mat(euler) -> torch.Tensor:
    """'xyz' relative Euler angles ``[..., 3]`` -> rotation matrices ``[..., 3, 3]``."""
    euler = _t(euler)
    ai, aj, ak = -euler[..., 2], -euler[..., 1], -euler[..., 0]
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    row0 = torch.stack([cj * ci, cj * si, -sj], -1)
    row1 = torch.stack([sj * cs - sc, sj * ss + cc, cj * sk], -1)
    row2 = torch.stack([sj * cc + ss, sj * sc - cs, cj * ck], -1)
    return torch.stack([row0, row1, row2], -2)


def euler2quat(euler) -> torch.Tensor:
    """'xyz' relative Euler angles ``[..., 3]`` -> quaternions ``[..., 4]``."""
    euler = _t(euler)
    ai, aj, ak = euler[..., 2] / 2, -euler[..., 1] / 2, euler[..., 0] / 2
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    w = cj * cc + sj * ss
    x = cj * cs - sj * sc
    y = -(cj * ss + sj * cc)
    z = cj * sc - sj * cs
    return torch.stack([w, x, y, z], -1)


def mat2euler(mat) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` -> 'xyz' Euler angles ``[..., 3]``."""
    mat = _t(mat)
    cy = torch.sqrt(mat[..., 2, 2] * mat[..., 2, 2] + mat[..., 1, 2] * mat[..., 1, 2])
    condition = cy > _EPS4
    e2 = torch.where(condition, -torch.atan2(mat[..., 0, 1], mat[..., 0, 0]),
                     -torch.atan2(-mat[..., 1, 0], mat[..., 1, 1]))
    e1 = -torch.atan2(-mat[..., 0, 2], cy)
    e0 = torch.where(condition, -torch.atan2(mat[..., 1, 2], mat[..., 2, 2]), torch.zeros_like(cy))
    return torch.stack([e0, e1, e2], -1)


def quat2mat(quat) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` of quaternions ``[..., 4]``; the
    identity where the squared norm is not above float64 epsilon."""
    quat = _t(quat)
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


def mat2quat(mat) -> torch.Tensor:
    """Rotation matrices ``[..., 3, 3]`` -> quaternions ``[..., 4]`` with
    ``w >= 0``: of the four candidates (from w, x, y or z), the one whose
    ``4 q_k^2`` is largest, normalised."""
    mat = _t(mat)
    m00, m01, m02 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    m10, m11, m12 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    m20, m21, m22 = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe(v):  # 4 q_k from 4 q_k^2, and a divisor that is never 0
        s = torch.sqrt(torch.clamp(v, min=0.0)) * 2.0
        return s, torch.where(s == 0, 1.0, s)

    sw, dw = safe(tw)
    sx, dx = safe(tx)
    sy, dy = safe(ty)
    sz, dz = safe(tz)
    q_w = torch.stack([0.25 * sw, (m21 - m12) / dw, (m02 - m20) / dw, (m10 - m01) / dw], -1)
    q_x = torch.stack([(m21 - m12) / dx, 0.25 * sx, (m01 + m10) / dx, (m02 + m20) / dx], -1)
    q_y = torch.stack([(m02 - m20) / dy, (m01 + m10) / dy, 0.25 * sy, (m12 + m21) / dy], -1)
    q_z = torch.stack([(m10 - m01) / dz, (m02 + m20) / dz, (m12 + m21) / dz, 0.25 * sz], -1)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], -1), -1)[..., None]
    q = torch.where(best == 0, q_w, torch.where(best == 1, q_x, torch.where(best == 2, q_y, q_z)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where((q[..., 0] < 0)[..., None], -q, q)


def quat2euler(quat) -> torch.Tensor:
    """Quaternion -> Euler angles, through the rotation matrix."""
    return mat2euler(quat2mat(quat))


def quat_conjugate(q) -> torch.Tensor:
    q = _t(q)
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_mul(q0, q1) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    w0, x0, y0, z0 = _t(q0).unbind(-1)
    w1, x1, y1, z1 = _t(q1).unbind(-1)
    w = w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1
    x = w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1
    y = w0 * y1 + y0 * w1 + z0 * x1 - x0 * z1
    z = w0 * z1 + z0 * w1 + x0 * y1 - y0 * x1
    return torch.stack([w, x, y, z], -1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rot_vec(q, v0) -> torch.Tensor:
    """Vectors ``v0 [..., 3]`` rotated by quaternions ``q [..., 4]`` (the
    expanded formula, two cross products)."""
    q, v0 = _t(q), _t(v0)
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v0)
    uuv = _cross(u, uv)
    return v0 + 2.0 * (w * uv + uuv)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity quaternion (1, 0, 0, 0)."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat2axisangle(quat) -> tuple[torch.Tensor, torch.Tensor]:
    """Quaternion -> (axis ``[..., 3]``, angle ``[...]``); axis (0, 0, 1) and
    angle 0 where ``|sin(theta / 2)| <= 1e-4``."""
    quat = _t(quat)
    sin_theta = torch.linalg.vector_norm(quat[..., 1:], dim=-1)
    big = sin_theta > 1e-4
    theta = 2.0 * torch.asin(torch.clamp(sin_theta, 0.0, 1.0))
    theta = torch.where(quat[..., 0] >= 0, theta, -theta)
    theta = torch.where(big, theta, torch.zeros_like(theta))
    default_axis = torch.tensor([0.0, 0.0, 1.0], dtype=quat.dtype, device=quat.device).expand(quat[..., 1:].shape)
    axis = torch.where(big[..., None], quat[..., 1:] / torch.where(big, sin_theta, 1.0)[..., None], default_axis)
    return axis, theta


def normalize_angles(angles) -> torch.Tensor:
    """Angles wrapped into [-pi, pi)."""
    return torch.remainder(_t(angles) + math.pi, 2 * math.pi) - math.pi


def subtract_euler(e1, e2) -> torch.Tensor:
    """The rotation e1 * e2^-1 as Euler angles."""
    return quat2euler(quat_mul(euler2quat(e1), quat_conjugate(euler2quat(e2))))


def unit_vector(data, dim: int = -1) -> torch.Tensor:
    """``data`` divided by its Euclidean norm along ``dim``."""
    data = _t(data)
    return data / sqrt((data * data).sum(dim, keepdim=True))


def quat_slerp(q0, q1, fraction, shortestpath: bool = True) -> torch.Tensor:
    """Spherical linear interpolation between quaternions, branch-free: the
    degenerate cases (fraction 0 or 1, parallel quaternions, a tiny angle)
    resolve by selection."""
    q0, q1 = unit_vector(_t(q0)), unit_vector(_t(q1))
    fraction = torch.as_tensor(fraction, dtype=q0.dtype, device=q0.device)
    d = (q0 * q1).sum(-1)
    if shortestpath:
        q1 = torch.where((d < 0.0)[..., None], -q1, q1)
        d = d.abs()
    d = torch.clamp(d, -1.0, 1.0)
    angle = torch.acos(d)
    small = angle.abs() < _EPS4
    safe_angle = torch.where(small, 1.0, angle)
    isin = 1.0 / torch.sin(safe_angle)
    w0 = torch.sin((1.0 - fraction) * safe_angle) * isin
    w1 = torch.sin(fraction * safe_angle) * isin
    out = w0[..., None] * q0 + w1[..., None] * q1
    out = torch.where(small[..., None], q0, out)
    out = torch.where((fraction == 0.0)[..., None], q0, out)
    return torch.where((fraction == 1.0)[..., None], q1, out)


def euler2point_euler(euler) -> torch.Tensor:
    """Euler angles ``[..., 3]`` -> the point form ``[sin(e), cos(e)]`` ``[..., 6]``."""
    euler = _t(euler)
    return torch.cat([torch.sin(euler), torch.cos(euler)], -1)


def point_euler2euler(pe) -> torch.Tensor:
    """The point form -> Euler angles: ``arctan(s / c)``, plus pi where
    ``c < 0`` (not ``arctan2``: the ranges differ in quadrant III)."""
    pe = _t(pe)
    s, c = pe[..., :3], pe[..., 3:]
    return torch.atan(s / c) + math.pi * (c < 0).to(pe.dtype)


def quat2point_quat(quat) -> torch.Tensor:
    """Quaternion -> the 5-vector point form ``[sin t, cos t, axis]``; the
    axis left unscaled where ``|sin(t / 2)| < 1e-5``."""
    quat = _t(quat)
    angle = torch.acos(torch.clamp(quat[..., :1], -1.0, 1.0)) * 2.0
    half_sin = torch.sin(angle / 2.0)
    safe = half_sin.abs() >= 1e-5
    xyz = quat[..., 1:]
    xyz = torch.where(safe, xyz / torch.where(safe, half_sin, 1.0), xyz)
    return torch.cat([torch.sin(angle), torch.cos(angle), xyz], -1)


def point_quat2quat(pq) -> torch.Tensor:
    """The inverse of ``quat2point_quat``."""
    pq = _t(pq)
    angle = torch.atan(pq[..., :1] / pq[..., 1:2])
    half_sin = torch.sin(angle / 2.0)
    safe = half_sin.abs() >= 1e-5
    qxyz = torch.where(safe, pq[..., 2:] * half_sin, pq[..., 2:])
    return torch.cat([torch.cos(angle / 2.0), qxyz], -1)


def round_to_straight_angles(angles) -> torch.Tensor:
    """Every angle snapped to the nearest multiple of 90 degrees, wrapped into [-pi, pi)."""
    half_pi = math.pi / 2.0
    return normalize_angles(torch.round(_t(angles) / half_pi) * half_pi)


def get_parallel_rotations() -> list[np.ndarray]:
    """The 24 axis-aligned (cube-symmetry) orientations as Euler triples:
    every product of multiples of 90 degrees, canonicalised through
    ``mat2euler(euler2mat(.))``, snapped to the lattice with -pi -> pi,
    deduplicated (host-side, a configuration helper)."""
    mult90 = [0.0, np.pi / 2, -np.pi / 2, np.pi]
    seen: list[np.ndarray] = []
    for e in itertools.product(mult90, repeat=3):
        canon = mat2euler(euler2mat(torch.tensor(e, dtype=torch.float64))).numpy()
        canon = np.round(canon / (np.pi / 2))
        canon[0] = 2.0 if canon[0] == -2 else canon[0]
        canon[2] = 2.0 if canon[2] == -2 else canon[2]
        canon *= np.pi / 2
        if not any(np.array_equal(canon, r) for r in seen):
            seen.append(canon)
    assert len(seen) == 24
    return seen
