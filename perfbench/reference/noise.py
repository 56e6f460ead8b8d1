"""The env kernels' random numbers, in plain PyTorch.

A frozen copy of the stream the program's CUDA kernels draw: Philox4x32-10
keyed by the launch seed ``(seed & 0xffffffff, seed >> 32)``; draw ``d`` of
env ``e`` is word ``d % 4`` of the block at counter ``(d // 4, e, 0, 0)``.
The top 23 bits of a word make the mantissa of a float in [1, 2), minus 1,
a uniform in [0, 1).  Normals come in pairs by Box-Muller on ``1 - u_a`` and
``u_b``.

On CPU tensors the program's plain versions draw their uniforms with
``torch.rand`` from a CPU generator seeded with the launch seed instead;
``launch_uniforms`` gives that stream there, so the benchmark's CPU
rehearsal compares like with like.

Products of two 32-bit words need 64 bits unsigned; PyTorch has no uint64
arithmetic, so ``_mulhilo`` splits the word into 16-bit halves and keeps
every partial product below 2**48 in int64.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
TWO_PI = 2.0 * math.pi


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    32-bit words ``b`` held in int64."""
    lo16, hi16 = b & 0xFFFF, b >> 16
    p_lo, p_hi = a * lo16, a * hi16  # each below 2**48
    low = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK
    high = (p_hi + (p_lo >> 16)) >> 16
    return high, low


def philox4x32_10(c0, c1, c2, c3, seed: int) -> list[torch.Tensor]:
    """The four output words of Philox4x32-10 at counters ``(c0, c1, c2, c3)``
    (int64 tensors of 32-bit words) under the key of ``seed``."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    c = [c0, c1, c2, c3]
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) from 32-bit words: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def philox_uniforms(seed: int, first: int, count: int, batch: int, device) -> torch.Tensor:
    """Draws ``first .. first + count - 1`` of every env of a launch keyed by
    ``seed``, as f32 uniforms ``[count, batch]``."""
    b0, b1 = first // 4, (first + count + 3) // 4
    blk = torch.arange(b0, b1, dtype=torch.int64, device=device)[:, None].expand(-1, batch)
    env = torch.arange(batch, dtype=torch.int64, device=device)[None, :].expand(b1 - b0, -1)
    zero = torch.zeros_like(blk)
    words = torch.stack(philox4x32_10(blk, env, zero, zero, seed), dim=1)  # [blocks, 4, batch]
    words = words.reshape(4 * (b1 - b0), batch)
    start = first - 4 * b0
    return uniform_from_bits(words[start:start + count])


def launch_uniforms(seed: int, count: int, batch: int, device) -> torch.Tensor:
    """The ``[count, batch]`` uniforms a launch keyed by ``seed`` consumes
    on ``device``: Philox on the card, ``torch.rand`` of a CPU generator
    seeded ``seed`` on the CPU (the program's plain versions)."""
    if torch.device(device).type == 'cpu':
        gen = torch.Generator(device='cpu').manual_seed(seed)
        return torch.rand((count, batch), generator=gen, dtype=torch.float32)
    return philox_uniforms(seed, 0, count, batch, device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (the float64 root rounded back): the
    card's ``sqrtf``; PyTorch's vectorised CPU root may be an ulp off."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


class Stream:
    """Uniform planes ``[N, B]`` consumed one plane a draw, in order."""

    def __init__(self, planes: torch.Tensor):
        self.planes = planes
        self.i = 0

    def uniform(self) -> torch.Tensor:
        if self.i >= self.planes.shape[0]:
            raise IndexError(f'drew more than the {self.planes.shape[0]} uniform planes given')
        u = self.planes[self.i]
        self.i += 1
        return u

    def normal_pair(self) -> tuple[torch.Tensor, torch.Tensor]:
        u_a = self.uniform()
        u_b = self.uniform()
        r = sqrt(-2.0 * torch.log(1.0 - u_a))
        th = TWO_PI * u_b
        return r * torch.cos(th), r * torch.sin(th)

    def uniform_in(self, lo: float, span: float) -> torch.Tensor:
        return lo + self.uniform() * span

    def done(self) -> None:
        if self.i != self.planes.shape[0]:
            raise IndexError(f'drew {self.i} uniform planes of the {self.planes.shape[0]} given')


class Replay:
    """``fn(*inputs)`` run eagerly on the CPU, and on the card captured once
    as a CUDA graph over fixed input buffers and replayed: the same
    operations on the same data, without a host launch per operation.
    ``fn`` reads nothing but its inputs and makes no host copy.  The
    returned tensors are the graph's own buffers, overwritten by the next
    call: a caller keeps a clone."""

    def __init__(self, fn, inputs: list):
        self.fn = fn
        self.graph = None
        if inputs[0].device.type != 'cuda':
            return
        self.static = [x.clone() for x in inputs]
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(inputs[0].device))
        with torch.cuda.stream(side):
            fn(*self.static)
        torch.cuda.current_stream(inputs[0].device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.static)

    def __call__(self, *inputs):
        if self.graph is None:
            return self.fn(*inputs)
        for buf, x in zip(self.static, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.out
