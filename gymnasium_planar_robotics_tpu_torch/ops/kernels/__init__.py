"""Kernel wrappers of the port.

Every wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the kernel's plain PyTorch version (in the same module), a CUDA
tensor launches the hand-written CUDA kernel (``csrc/``) or raises.  There is
no fallback from the kernel to the plain version.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import torch

LAUNCHES = {'noise_probe': 0, 'pushing_cycles': 0, 'pushing_autoreset': 0, 'pushing_rollout': 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    types = {t.device.type for t in tensors if t is not None}
    if types == {'cpu'}:
        return False
    if types == {'cuda'}:
        return True
    raise ValueError(f'kernel inputs must all be on the CPU or all on one CUDA device, got {sorted(types)}')


def check_plane(t: torch.Tensor, name: str, shape: tuple) -> None:
    """Kernel input contract: f32, contiguous, exactly ``shape``."""
    if t.dtype != torch.float32:
        raise TypeError(f'{name} must be float32, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must have shape {tuple(shape)}, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
