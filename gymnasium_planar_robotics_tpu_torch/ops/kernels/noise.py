"""Noise machinery: mantissa-bitcast uniforms, Box-Muller, the injected
uniform stream, Philox4x32-10, and kernel A (the noise probe).

Counterpart of ``gymnasium_planar_robotics_tpu/ops/pallas_step.py:50-175``
and ``make_noise_probe``.  The plain versions always consume uniforms in
[0, 1): given ones (the injected mode, in the Pallas kernels' draw order) or
ones drawn with ``torch.rand`` from a generator.  The CUDA kernels either
read given uniforms or draw their own from a Philox4x32-10 stream keyed by
the launch seed, counter ``(draw // 4, env, 0, 0)``; ``philox_uniforms``
is that stream on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt

TWO_PI = 2.0 * np.pi


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) from 32 random bits (``pallas_step._uniform``): the top
    23 bits become the mantissa of a float in [1, 2), minus 1.  ``bits``
    holds uint32 values in any integer dtype."""
    b = bits.to(torch.int64) & 0xFFFFFFFF
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def box_muller(u_a: torch.Tensor, u_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two iid standard normals from two uniforms (``_NoiseBase.normal_pair``):
    ``u1 = 1 - u_a`` in (0, 1] keeps the log finite."""
    u1 = 1.0 - u_a
    r = sqrt(-2.0 * torch.log(u1))
    th = TWO_PI * u_b
    return r * torch.cos(th), r * torch.sin(th)


class UniformStream:
    """Consumes pre-drawn uniform planes ``[N, B]`` one plane per draw, in
    order (``pallas_step._InjectedNoise``; the Pallas cycle loop's plane
    index ``start + i*per_cycle + j`` is this sequential order).
    ``finalize`` asserts that exactly ``N`` planes were drawn."""

    def __init__(self, planes: torch.Tensor):
        self.planes = planes
        self.i = 0

    def uniform(self) -> torch.Tensor:
        assert self.i < self.planes.shape[0], f'drew more than the {self.planes.shape[0]} given noise planes'
        u = self.planes[self.i]
        self.i += 1
        return u

    def normal_pair(self) -> tuple[torch.Tensor, torch.Tensor]:
        u_a = self.uniform()
        return box_muller(u_a, self.uniform())

    def uniform_in(self, lo: float, span: float) -> torch.Tensor:
        """``lo + u * span``; ``span`` is the float64 ``hi - lo`` (the Pallas
        kernel forms it in Python before rounding)."""
        return lo + self.uniform() * span

    def finalize(self) -> None:
        assert self.i == self.planes.shape[0], f'drew {self.i} noise planes but {self.planes.shape[0]} were given'


# ---------------------------------------------------------------------------
# Philox4x32-10 on the host (the kernels' in-kernel stream)
# ---------------------------------------------------------------------------

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint32(0x9E3779B9), np.uint32(0xBB67AE85)


def philox4x32_10(ctr: np.ndarray, key: tuple[int, int]) -> np.ndarray:
    """Philox4x32-10 of counters ``[4, N]`` uint32 under a 2-word key."""
    c = [np.asarray(x, np.uint32).copy() for x in ctr]
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    mask = np.uint64(0xFFFFFFFF)
    with np.errstate(over='ignore'):
        for _ in range(10):
            p0 = _M0 * c[0].astype(np.uint64)
            p1 = _M1 * c[2].astype(np.uint64)
            hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), (p0 & mask).astype(np.uint32)
            hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), (p1 & mask).astype(np.uint32)
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
            k0 = np.uint32(k0 + _W0)
            k1 = np.uint32(k1 + _W1)
    return np.stack(c)


def philox_bits(seed: int, n_draws: int, batch: int, envs=None) -> np.ndarray:
    """The kernels' random words ``[n_draws, batch]`` uint32 for one launch
    seed: draw ``d`` of env ``e`` is word ``d % 4`` of Philox at counter
    ``(d // 4, e, 0, 0)`` under key ``(seed & 0xffffffff, seed >> 32)``.
    With ``envs`` (``batch`` indices), the words of those envs only."""
    n_blocks = -(-n_draws // 4)
    envs = np.arange(batch) if envs is None else np.asarray(envs)
    assert envs.shape == (batch,)
    blk, env = np.meshgrid(np.arange(n_blocks, dtype=np.uint32), envs.astype(np.uint32), indexing='ij')
    zeros = np.zeros_like(blk)
    out = philox4x32_10(np.stack([blk.ravel(), env.ravel(), zeros.ravel(), zeros.ravel()]),
                        (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF))
    words = out.reshape(4, n_blocks, batch).transpose(1, 0, 2).reshape(4 * n_blocks, batch)
    return words[:n_draws]


def philox_uniforms(seed: int, n_draws: int, batch: int, envs=None) -> torch.Tensor:
    """The uniforms a kernel launched with ``seed`` draws, ``[n_draws, batch]``
    (of ``envs`` only, if given)."""
    return uniform_from_bits(torch.from_numpy(philox_bits(seed, n_draws, batch, envs).astype(np.int64)))


# ---------------------------------------------------------------------------
# kernel A: the noise probe
# ---------------------------------------------------------------------------

#: kernel A's block size, and the cap on its grid's rows of units in waves
#: of the card's resident threads (``probe_grid``; ``csrc/noise_probe.cu``)
A_THREADS = 128
A_WAVES = 1
#: the resident threads of an H100 SXM (132 SMs x 2048): the mirror's
#: default; a launch reads its card's
H100_RESIDENT = 132 * 2048


def probe_grid(draws: int, batch: int, inject: bool, resident: int = H100_RESIDENT):
    """(grid_x, grid_y, threads) of kernel A for ``draws`` pairs of ``batch``
    envs: ``grid_x`` blocks of ``A_THREADS`` cover the envs; ``grid_y`` rows
    of blocks walk the units (Philox blocks, or pairs in the injected mode),
    as many as there are up to ``A_WAVES`` waves of ``resident`` threads
    (and the card's 65,535 rows)."""
    units = draws if inject else -(-draws // 2)
    gx = -(-batch // A_THREADS)
    rows = max(1, -(-A_WAVES * resident // (gx * A_THREADS)))
    return gx, min(units, rows, 65535), A_THREADS


def probe_writes(draws: int, batch: int, inject: bool, resident: int = H100_RESIDENT):
    """A mirror of kernel A's map from thread to work on ``probe_grid``'s
    grid: for every normal it writes, arrays ``(thread, row, env, block,
    word)``: thread ``thread`` (numbered ``(by * gx + bx) * threads + tid``)
    writes output row ``row`` of env ``env`` from word ``word`` of the Philox
    block at counter ``(block, env, 0, 0)`` (in the injected mode, from
    uniform row ``row``).  The CPU tests hold it to every ``(row, env)``
    written once, from the word ``philox_bits`` puts there; nothing on the
    card's path uses it."""
    gx, gy, threads = probe_grid(draws, batch, inject, resident)
    units = draws if inject else -(-draws // 2)
    by, bx, tid = np.meshgrid(np.arange(gy), np.arange(gx), np.arange(threads), indexing='ij')
    thread, env, first = ((by * gx + bx) * threads + tid).ravel(), (bx * threads + tid).ravel(), by.ravel()
    live = env < batch
    thread, env, first = thread[live], env[live], first[live]
    parts = []
    for unit0 in range(0, units, gy):  # the loop's trips: unit first + unit0
        unit = first + unit0
        on = unit < units
        if inject:
            halves = [(0, on)]  # rows 2p, 2p + 1
            base = 2 * unit
        else:
            halves = [(0, on), (2, on & (2 * unit + 1 < draws))]  # pairs 2k and, if it exists, 2k + 1
            base = 4 * unit
        for off, keep in halves:
            for r in (off, off + 1):
                parts.append((thread[keep], (base + r)[keep], env[keep]))
    thread, row, env = (np.concatenate(x) for x in zip(*parts))
    return thread, row, env, row // 4, row % 4


def noise_probe_plain(uniforms: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: ``[2*draws, B]`` uniforms -> ``[2*draws, B]``
    standard normals, pair by pair."""
    stream = UniformStream(uniforms)
    out = []
    for _ in range(uniforms.shape[0] // 2):
        out += list(stream.normal_pair())
    stream.finalize()
    return torch.stack(out)


def _cuda_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'{what} needs a CUDA device, got {device}')
    return torch.device('cuda', torch.cuda.current_device()) if device.index is None else device


def resident_threads(device: torch.device) -> int:
    """Threads the card holds at once: its SMs times threads an SM."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def noise_probe_cuda(draws: int, batch: int, device, uniforms: torch.Tensor | None = None,
                     seed: int | torch.Tensor = 0) -> torch.Tensor:
    """Kernel A on the card: injected ``uniforms`` or the Philox stream of
    ``seed`` (an int, or a one-element int64 tensor on the card)."""
    device = _cuda_device(device, 'noise_probe_cuda')
    if uniforms is not None:
        kernels.check_plane(uniforms, 'uniforms', (2 * draws, batch))
        if uniforms.device != device:
            raise ValueError(f'uniforms lie on {uniforms.device}, expected {device}')
    out = torch.empty((2 * draws, batch), dtype=torch.float32, device=device)
    grid = probe_grid(draws, batch, uniforms is not None, resident_threads(device))
    with torch.cuda.device(device):
        err = build.lib().gprt_noise_probe(
            uniforms.data_ptr() if uniforms is not None else None, out.data_ptr(), batch, draws,
            *kernels.seed_args(seed, device), *grid, kernels.stream_ptr(out),
        )
    build.check(err, 'noise_probe')
    kernels.LAUNCHES['noise_probe'] += 1
    return out


def empty_launch_cuda(batch: int, device, draws: int, inject: bool) -> None:
    """An empty kernel on kernel A's grid for ``draws`` pairs of ``batch``
    envs in the given mode: the floor of a launch of A's shape, timed beside
    it (no plain version: it computes nothing; not counted in ``LAUNCHES``,
    as no path launches it)."""
    device = _cuda_device(device, 'empty_launch_cuda')
    grid = probe_grid(draws, batch, inject, resident_threads(device))
    with torch.cuda.device(device):
        build.check(build.lib().gprt_empty_launch(*grid, torch.cuda.current_stream(device).cuda_stream),
                    'empty_launch')


def noise_probe(draws: int, batch: int, device, *, uniforms: torch.Tensor | None = None, seed: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """``[2*draws, batch]`` standard normals on ``device`` by Box-Muller.

    CPU: the plain version over ``uniforms`` (or ones drawn from
    ``generator``).  CUDA: kernel A over ``uniforms`` when given, else over
    its Philox stream keyed by ``seed``, which is drawn from ``generator``
    when not given (``kernels.draw_seed``: a card tensor from a generator on
    the card, so no call waits on the host; an int from a CPU generator)."""
    device = torch.device(device)
    if device.type == 'cpu':
        if uniforms is None:
            uniforms = kernels.draw_uniforms(2 * draws, batch, device, generator)
        return noise_probe_plain(uniforms)
    if device.type != 'cuda':
        raise ValueError(f'unsupported device {device}')
    if uniforms is None and seed is None:
        seed = kernels.draw_seed(generator)
    return noise_probe_cuda(draws, batch, device, uniforms, 0 if seed is None else seed)
