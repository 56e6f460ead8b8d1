"""Kernel wrappers of the port.

Every wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the kernel's plain PyTorch version (in the same module), a CUDA
tensor launches the hand-written CUDA kernel (``csrc/``) or raises.  There is
no fallback from the kernel to the plain version.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else.  While the program's spans are on
(``utils/profiling``), every ``dispatch`` runs inside a ``gprt.launch``
span.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.utils import profiling

LAUNCHES = {
    'noise_probe': 0, 'pushing_cycles': 0, 'pushing_autoreset': 0, 'pushing_autoreset_features': 0,
    'pushing_rollout': 0, 'pushing_cycles_box': 0, 'pushing_autoreset_box': 0, 'pushing_autoreset_features_box': 0,
    'pushing_rollout_box': 0,
    'planning_cycles': 0, 'planning_autoreset': 0, 'planning_rollout': 0, 'planning_multi_autoreset': 0,
    'planning_multi_autoreset_many': 0, 'peak_fma': 0, 'peak_transc': 0, 'policy_mlp': 0,
}


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


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def draw_uniforms(n: int, batch: int, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """``[n, batch]`` f32 uniforms from ``generator`` (drawn on the
    generator's device, then moved to ``device``), or from ``device``'s
    default generator."""
    gdev = generator.device if generator is not None else torch.device(device)
    return torch.rand((n, batch), generator=generator, device=gdev, dtype=torch.float32).to(device)


def draw_seed(generator: torch.Generator | None = None) -> int | torch.Tensor:
    """A Philox launch seed drawn from ``generator``: an int from a CPU
    generator (or the CPU's default one), a one-element int64 tensor from a
    generator on the card.  The kernel reads the tensor at entry, so the
    seed never travels to the host (no launch waits for the card, and a
    captured graph replays the draw)."""
    if generator is not None and generator.device.type == 'cuda':
        return torch.randint(0, 2**31 - 1, (1,), generator=generator, device=generator.device)
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def seed_args(seed: int | torch.Tensor, device) -> tuple[int, int | None]:
    """The two seed arguments of a kernel's C interface: an int goes by
    value (address None), a one-element int64 tensor on ``device`` by its
    address.  Either keys the same Philox stream for the same value.  The
    tensor may be freed once the launch is enqueued: the caching allocator
    hands its memory out again only in the stream's order, after the kernel
    has read it."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != torch.device(device):
            raise ValueError(f'a seed tensor must be one int64 on {device}, got {seed.dtype} {tuple(seed.shape)} '
                             f'on {seed.device}')
        return 0, seed.data_ptr()
    return seed & 0xFFFFFFFFFFFFFFFF, None


def noise_ptr(uniforms: torch.Tensor | None, n: int, b: int, device) -> int | None:
    """Address of injected uniforms ``[n, b]`` on ``device``; None selects
    the kernel's Philox stream."""
    if uniforms is None:
        return None
    check_plane(uniforms, 'uniforms', (n, b))
    if uniforms.device != device:
        raise ValueError(f'uniforms lie on {uniforms.device}, expected {device}')
    return uniforms.data_ptr()


@profiling.spanned(profiling.LAUNCH)
def dispatch(inputs: tuple, n_noise: int, uniforms, seed: int | None, generator, plain, cuda):
    """One kernel call by the device of its tensors.

    CPU: ``plain(uniforms)``, with ``[n_noise, B]`` uniforms drawn from
    ``generator`` when none are given.  CUDA: ``cuda(uniforms, seed)``;
    without ``uniforms`` the kernel draws its Philox stream under ``seed``
    (``draw_seed(generator)`` when not given: on the card for a card
    generator)."""
    if not on_cuda(*inputs, uniforms):
        if uniforms is None:
            uniforms = draw_uniforms(n_noise, inputs[0].shape[1], inputs[0].device, generator)
        return plain(uniforms)
    if uniforms is None and seed is None:
        seed = draw_seed(generator)
    return cuda(uniforms, 0 if seed is None else seed)
