"""Kernel I: the roofline's peak probes (``csrc/peaks.cu``).

Counterpart of ``fma_kern`` and ``transc_kern`` in the JAX package's
``bench._microbench_peaks``: element by element, K steps of a dependent
chain from ``acc = x``, returning the last ``acc``:

- fma: ``acc = acc * 1.0000001 + x`` (2 flops a step);
- transc: ``acc = cos(sqrt(-2 log(acc * 0.49 + 0.5))) * 0.5 + 0.5`` (the
  Box-Muller mix, 3 transcendental operations a step), kept in (0, 1).

The plain versions round as the JAX bodies do (the product, then the sum);
the card's fma chain rounds once per step (``fmaf``), and its transc chain
uses the CUDA math library's ``logf``/``sqrtf``/``cosf``.  CPU tensors run
the plain version, CUDA tensors the kernel (or raise).
"""

from __future__ import annotations

import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt

FMA_SCALE = 1.0000001
#: operations counted per element and step, as ``bench.py`` counts them
FMA_OPS, TRANSC_OPS = 2, 3


def fma_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    acc = x
    for _ in range(k):
        acc = acc * FMA_SCALE + x
    return acc


def fma_once_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The fma chain rounded once a step, as ``fmaf`` rounds: the product
    by the f32 multiplier and the sum in float64, then rounded to f32.  For
    x in (0, 1) and K below 2^24 the float64 product (48 bits) and sum
    (acc / x below 2^29) are exact, so the result is ``fmaf``'s, bit for
    bit."""
    scale = float(torch.tensor(FMA_SCALE, dtype=torch.float32))  # 1 + 2^-23
    xd, acc = x.double(), x
    for _ in range(k):
        acc = (acc.double() * scale + xd).float()
    return acc


def transc_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    acc = x
    for _ in range(k):
        u = acc * 0.49 + 0.5
        acc = torch.cos(sqrt(-2.0 * torch.log(u))) * 0.5 + 0.5
    return acc


def chains(transc: bool) -> int:
    """Independent chains each thread of the kernel runs: a probe's length
    must be a multiple of it."""
    return build.lib().gprt_peak_chains(int(transc))


def probe_length(device, transc: bool, blocks_per_sm: int = 4) -> int:
    """Elements that fill the card: ``blocks_per_sm`` blocks of 256 threads
    on every SM, each thread ``chains(transc)`` elements."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * blocks_per_sm * 256 * chains(transc)


def peak_cuda(x: torch.Tensor, k: int, transc: bool) -> torch.Tensor:
    """Kernel I on the card: ``x`` f32, contiguous, 1-D, its length a
    multiple of ``chains(transc)``."""
    kernels.check_plane(x, 'x', (x.numel(),))
    if x.device.type != 'cuda':
        raise ValueError(f'peak_cuda needs a CUDA tensor, got {x.device}')
    if x.numel() % chains(transc):
        raise ValueError(f'the probe length {x.numel()} is not a multiple of {chains(transc)}')
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.lib().gprt_peak(x.data_ptr(), out.data_ptr(), x.numel(), k, int(transc), kernels.stream_ptr(out))
    name = 'peak_transc' if transc else 'peak_fma'
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return out


def peak(x: torch.Tensor, k: int, transc: bool = False) -> torch.Tensor:
    """K steps of the fma (or transc) chain of every element of ``x``."""
    if not kernels.on_cuda(x):
        return transc_plain(x, k) if transc else fma_plain(x, k)
    return peak_cuda(x, k, transc)
