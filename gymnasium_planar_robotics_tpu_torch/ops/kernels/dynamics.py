"""One mover's clamp chain, plain PyTorch (``csrc/common.cuh`` on the card).

Counterpart of ``pallas_step._clamp_norm2`` and the clamp chain of
``pallas_step._integrate_mover`` (the pushing cycles run the same chain).
Every operation rounds on its own, as the kernels do.
"""

from __future__ import annotations

import torch


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim f32 tensor on ``like``'s device.  Dividing by it is
    IEEE division on every device: PyTorch turns a Python-float divisor of a
    CUDA tensor into a multiply by its reciprocal, which the kernels do not."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of an f32 tensor on every device, as
    ``sqrtf`` on the card and XLA's ``sqrt`` give it: PyTorch's CPU ``sqrt``
    (vectorised, MKL) can be one ulp off.  The float64 root rounded to f32
    is the f32 root (53 >= 2 * 24 + 2 bits, so double rounding is exact)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def clamp_norm2(x, y, max_val: float):
    """L2-ball clamp of (x, y): inclusive ``>=``, ``max * v / norm`` order."""
    norm = sqrt(x * x + y * y)
    clamp = norm >= max_val
    safe = torch.where(norm > 0, norm, 1.0)
    cx = max_val * x / safe
    cy = max_val * y / safe
    return torch.where(clamp, cx, x), torch.where(clamp, cy, y), clamp


def clamp_chain(jerk: bool, v_max: float, a_max: float, dt: float, dt_t: torch.Tensor, vmx, vmy, ux, uy,
                amx, amy, bx, by):
    """The clamp chain of one cycle (``clamp_chain`` in ``csrc/common.cuh``):
    ``(vmx, vmy)`` the noisy velocity reading, ``(ux, uy)`` the action,
    ``dt_t`` = ``scalar(dt, ...)``.

    Acceleration mode: the applied command, the action unless the velocity
    clamp fires, then ``(v_clamped - v) / dt``.  Jerk mode: ``(amx, amy)``
    is the measured acceleration, ``(bx, by)`` the integrator state; the new
    integrator state ``b + dt * jerk``, the jerk re-derived where a clamp
    fires."""
    if jerk:
        cax, cay, aclamp = clamp_norm2(amx + dt * ux, amy + dt * uy, a_max)
        j1x = torch.where(aclamp, (cax - amx) / dt_t, ux)
        j1y = torch.where(aclamp, (cay - amy) / dt_t, uy)
        cnx, cny, vclamp = clamp_norm2(vmx + dt * cax, vmy + dt * cay, v_max)
        fax = torch.where(vclamp, (cnx - vmx) / dt_t, cax)
        fay = torch.where(vclamp, (cny - vmy) / dt_t, cay)
        diff = (fax != cax) | (fay != cay)
        jx = torch.where(diff, (fax - amx) / dt_t, j1x)
        jy = torch.where(diff, (fay - amy) / dt_t, j1y)
        return bx + dt * jx, by + dt * jy
    cnx, cny, vclamp = clamp_norm2(vmx + dt * ux, vmy + dt * uy, v_max)
    # the unclamped branch applies the raw action, not (v' - v) / dt
    return torch.where(vclamp, (cnx - vmx) / dt_t, ux), torch.where(vclamp, (cny - vmy) / dt_t, uy)
