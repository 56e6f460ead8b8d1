"""Planar box-push contact of the eager pushing step.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/contact.py``: the
quasi-2D penalty contact between the mover box and the pushed box (normal
force ``k * pen - b * v_sep`` along the face normal, capped viscous
tangential friction, equal and opposite on the mover) and the object's
discrete Coulomb floor friction.  ``box_push_contact_v2`` adds the object's
yaw, the hysteretic face normal (``sticky_axis``), the contact torque, the
elliptic cone's vertical share and the wedge cap ``fz_cap``; its
calibration and the reasons for each term are in the JAX module.

The operations run in the JAX module's order: the fused kernels'
tolerances against the eager step rest on it.  Batched over leading
dimensions, the last one the (x, y) pair where there is one; any float
dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gymnasium_planar_robotics_tpu_torch.ops.dynamics import norm
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt


class ContactForces(NamedTuple):
    f_obj: torch.Tensor  # [..., 2] force on the object
    f_mover: torch.Tensor  # [..., 2] reaction on the mover
    penetration: torch.Tensor
    in_contact: torch.Tensor


def _minimum(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.minimum`` with ``b`` a tensor or a Python float (which stays on
    the host: no copy to the card)."""
    return torch.minimum(a, b) if isinstance(b, torch.Tensor) else torch.clamp(a, max=b)


def box_push_contact(mover_xy, mover_vel, obj_xy, obj_vel, mover_half, obj_half, k_n, b_n, b_t, mu) -> ContactForces:
    """Axis-aligned box-box penalty contact (the first model, without yaw)."""
    d = obj_xy - mover_xy
    overlap = (mover_half + obj_half) - torch.abs(d)
    in_contact = (overlap > 0).all(-1)
    axis_x = overlap[..., 0] < overlap[..., 1]
    pen = torch.where(axis_x, overlap[..., 0], overlap[..., 1])
    sign = torch.where(axis_x, torch.sign(d[..., 0]), torch.sign(d[..., 1]))
    sign = torch.where(sign == 0, 1.0, sign)
    n = torch.stack([torch.where(axis_x, sign, 0.0), torch.where(axis_x, 0.0, sign)], -1)
    v_rel = obj_vel - mover_vel
    vn = (v_rel * n).sum(-1)
    f_n_mag = torch.clamp(k_n * pen - b_n * vn, min=0.0)
    t = torch.stack([-n[..., 1], n[..., 0]], -1)
    vt = (v_rel * t).sum(-1)
    lim = mu * f_n_mag
    f_t_mag = torch.minimum(torch.maximum(-b_t * vt, -lim), lim)
    f_obj = (f_n_mag[..., None] * n + f_t_mag[..., None] * t) * in_contact[..., None]
    return ContactForces(f_obj=f_obj, f_mover=-f_obj, penetration=torch.clamp(pen, min=0.0) * in_contact,
                         in_contact=in_contact)


def coulomb_floor_step(vel: torch.Tensor, mu_g_dt, eps: float = 1e-12) -> torch.Tensor:
    """One discrete Coulomb floor-friction update: the speed shrinks by up to
    ``mu * g * dt``, stopping instead of reversing."""
    speed = norm(vel, keepdim=True)
    scale = torch.clamp(1.0 - mu_g_dt / torch.clamp(speed, min=eps), min=0.0)
    return vel * scale


class ContactForcesV2(NamedTuple):
    f_obj: torch.Tensor  # [..., 2] force on the object
    f_mover: torch.Tensor  # [..., 2] reaction on the mover
    torque_obj: torch.Tensor  # [...] z-torque on the object about its centre
    penetration: torch.Tensor
    in_contact: torch.Tensor
    f_n_mag: torch.Tensor  # normal-force magnitude
    f_imp: torch.Tensor  # the damping (impact) part of the normal force: the plow load
    axis: torch.Tensor  # chosen normal axis: 0 x, 1 y, -1 no contact (the hysteresis carry)
    f_z: torch.Tensor  # vertical (into-floor) friction component at the contact


def box_push_contact_v2(mover_xy, mover_vel, obj_xy, obj_vel, obj_yaw, obj_w, mover_half, obj_half, k_n, b_n, b_t,
                        mu, sticky_axis=None, cone_zeta=0.0, cone_vt=0.05, cone_vt_hi=1e9, cone_vt_off=2e9,
                        fz_cap=1e9) -> ContactForcesV2:
    """Corner-aware planar box-box penalty contact with the object's yaw.

    The object's yaw enters through its rotated AABB extents; the normal is
    the minimum-translation face normal (ties to x), kept on ``sticky_axis``
    while that axis still overlaps; the force acts at the overlap region's
    centre (a torque on the object); during tangential slip a vertical
    share ``f_z`` of the normal force, band-passed in the slip speed and
    capped at ``fz_cap``, takes its part of the friction cone's budget."""
    cos = torch.cos(obj_yaw)
    sin = torch.sin(obj_yaw)
    rx = torch.abs(cos) * obj_half[0] + torch.abs(sin) * obj_half[1]
    ry = torch.abs(sin) * obj_half[0] + torch.abs(cos) * obj_half[1]

    d = obj_xy - mover_xy
    olx = (mover_half[0] + rx) - torch.abs(d[..., 0])
    oly = (mover_half[1] + ry) - torch.abs(d[..., 1])
    in_contact = (olx > 0) & (oly > 0)
    olx_c = torch.clamp(olx, min=0.0)
    oly_c = torch.clamp(oly, min=0.0)

    sx = torch.where(d[..., 0] == 0, 1.0, torch.sign(d[..., 0]))
    sy = torch.where(d[..., 1] == 0, 1.0, torch.sign(d[..., 1]))
    axis_x = olx_c <= oly_c
    if sticky_axis is not None:
        keep_x = (sticky_axis == 0.0) & (olx > 0)
        keep_y = (sticky_axis == 1.0) & (oly > 0)
        axis_x = keep_x | (axis_x & ~keep_y)
    nx = torch.where(axis_x, sx, 0.0)
    ny = torch.where(axis_x, 0.0, sy)
    pen = torch.where(axis_x, olx_c, oly_c)

    # contact point: the centre of the overlap rectangle
    lo_x = torch.maximum(mover_xy[..., 0] - mover_half[0], obj_xy[..., 0] - rx)
    hi_x = torch.minimum(mover_xy[..., 0] + mover_half[0], obj_xy[..., 0] + rx)
    lo_y = torch.maximum(mover_xy[..., 1] - mover_half[1], obj_xy[..., 1] - ry)
    hi_y = torch.minimum(mover_xy[..., 1] + mover_half[1], obj_xy[..., 1] + ry)
    cpx = 0.5 * (lo_x + hi_x)
    cpy = 0.5 * (lo_y + hi_y)

    # relative velocity at the contact point, the object's rotation included
    r_ox = cpx - obj_xy[..., 0]
    r_oy = cpy - obj_xy[..., 1]
    v_obj_cx = obj_vel[..., 0] - obj_w * r_oy
    v_obj_cy = obj_vel[..., 1] + obj_w * r_ox
    vrx = v_obj_cx - mover_vel[..., 0]
    vry = v_obj_cy - mover_vel[..., 1]
    vn = vrx * nx + vry * ny
    f_n_mag = torch.clamp(k_n * pen - b_n * vn, min=0.0)

    tx = -ny
    ty = nx
    vt = vrx * tx + vry * ty
    f_imp = torch.minimum(torch.clamp(-b_n * vn, min=0.0), f_n_mag)
    avt = torch.abs(vt)
    slip = torch.clamp(avt / cone_vt, max=1.0) * torch.clamp((cone_vt_off - avt) / (cone_vt_off - cone_vt_hi),
                                                              0.0, 1.0)
    f_z = _minimum(cone_zeta * f_n_mag * slip, fz_cap)
    budget = mu * f_n_mag
    cap = torch.where(f_z > 0, sqrt(torch.clamp(budget * budget - f_z * f_z, min=0.0)), budget)
    f_t_mag = torch.minimum(torch.maximum(-b_t * vt, -cap), cap)

    cmask = in_contact.to(pen.dtype)
    fx = (f_n_mag * nx + f_t_mag * tx) * cmask
    fy = (f_n_mag * ny + f_t_mag * ty) * cmask
    torque = r_ox * fy - r_oy * fx
    f_obj = torch.stack([fx, fy], -1)
    return ContactForcesV2(
        f_obj=f_obj, f_mover=-f_obj, torque_obj=torque, penetration=pen * cmask, in_contact=in_contact,
        f_n_mag=f_n_mag * cmask, f_imp=f_imp * cmask, axis=torch.where(in_contact, (~axis_x).to(pen.dtype), -1.0),
        f_z=f_z * cmask,
    )


def coulomb_spin_step(omega: torch.Tensor, mu_spin_dt) -> torch.Tensor:
    """Discrete Coulomb torsional floor friction: ``|omega|`` shrinks by up
    to ``mu_spin * dt`` toward zero."""
    return torch.sign(omega) * torch.clamp(torch.abs(omega) - mu_spin_dt, min=0.0)
