"""Kernel P: the reactive policy step in one launch (``csrc/policy_mlp.cu``).

``policy_mlp(x, eps, trunk, mu, value, log_std, scale)`` computes what
``models/ppo.sample_action_pm`` computes from the actor-critic's parameters:
the tanh trunk over the features ``x [F, B]``, the ``mu`` and value heads,
``raw = mu + exp(log_std) * eps``, its Gaussian log-probability and the
action clamped to ``[-scale, scale]``; it returns ``(action [A, B], raw
[A, B], logp [B], value [B])``.  ``trunk`` is a sequence of ``(weight [out,
in], bias [out])`` pairs (``nn.Linear``'s layout), ``mu`` and ``value`` are
such pairs too.

A CPU tensor runs the plain version (``policy_mlp_plain``: the torch ops of
``sample_action_pm``); a CUDA tensor launches the kernel or raises.  The
kernel reads the parameters in place on every call (no copy, no cache), so
an in-place update is seen by the next call.  It has no backward: on the
card it runs with autograd not recording.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build
from gymnasium_planar_robotics_tpu_torch.utils import profiling

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
# The kernel's contract lives here: ``kernel_args`` raises with the limit
# named and picks the env tile; the C function only re-checks it defensively.
#: trunk layers the kernel takes
MAX_DEPTH = 8
#: actions the kernel takes (the heads' partials fill the activation tile)
MAX_ACTIONS = 7
#: (widest layer, env tile): a block carries ``tile`` envs through every
#: layer in a ``[widest, tile]`` f32 activation tile of 64 KB
TILES = ((256, 64), (512, 32), (1024, 16))
MAX_WIDTH = TILES[-1][0]


def env_tile(widest: int) -> int:
    """The env tile for the widest layer (features included)."""
    for width, tile in TILES:
        if widest <= width:
            return tile
    raise ValueError(f'the policy kernel takes layers up to {MAX_WIDTH} wide, got {widest}')


def forward_plain(x: torch.Tensor, trunk, mu, value):
    """The actor-critic plane-major: ``x [F, B] -> (mu [A, B], value [B])``."""
    for weight, bias in trunk:
        x = torch.tanh(torch.addmm(bias[:, None], weight, x))
    return torch.addmm(mu[1][:, None], mu[0], x), torch.addmm(value[1][:, None], value[0], x)[0]


def policy_mlp_plain(x: torch.Tensor, eps: torch.Tensor, trunk, mu, value, log_std: torch.Tensor, scale: float):
    """The plain version: torch ops, differentiable."""
    mean, v = forward_plain(x, trunk, mu, value)
    std = torch.exp(log_std)[:, None]
    raw = mean + std * eps
    logp = (-0.5 * ((raw - mean) / std) ** 2 - log_std[:, None] - HALF_LOG_2PI).sum(0)
    return torch.clamp(raw, -scale, scale), raw, logp, v


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    kernels.check_plane(t, name, shape)
    if t.device != device:
        raise ValueError(f'{name} lies on {t.device}, expected {device}')


def kernel_args(x: torch.Tensor, eps: torch.Tensor, trunk, mu, value, log_std: torch.Tensor):
    """The kernel's contract, checked: every tensor f32, contiguous, of its
    shape and on ``x``'s device; 1 to ``MAX_DEPTH`` trunk layers, 1 to
    ``MAX_ACTIONS`` actions, every layer (features included) at most
    ``MAX_WIDTH`` wide.  Returns ``(inputs in the C interface's order, dims:
    features and widths, env tile)``."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f'x must be [features, batch] with a batch of at least one, got {tuple(x.shape)}')
    depth, a = len(trunk), log_std.shape[0] if log_std.dim() == 1 else -1
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f'the policy kernel takes 1 to {MAX_DEPTH} trunk layers, got {depth}')
    if not 1 <= a <= MAX_ACTIONS:
        raise ValueError(f'the policy kernel takes 1 to {MAX_ACTIONS} actions, got log_std {tuple(log_std.shape)}')
    (f, b), dev = x.shape, x.device
    dims = [f] + [w.shape[0] for w, _ in trunk]
    tile = env_tile(max(dims))
    _check(x, 'x', (f, b), dev)
    _check(eps, 'eps', (a, b), dev)
    tensors = [x, eps]
    for i, (w, bias) in enumerate(trunk):
        _check(w, f'trunk[{i}].weight', (dims[i + 1], dims[i]), dev)
        _check(bias, f'trunk[{i}].bias', (dims[i + 1],), dev)
        tensors += [w, bias]
    h = dims[-1]
    for t, name, shape in ((mu[0], 'mu.weight', (a, h)), (mu[1], 'mu.bias', (a,)), (value[0], 'value.weight', (1, h)),
                           (value[1], 'value.bias', (1,)), (log_std, 'log_std', (a,))):
        _check(t, name, shape, dev)
        tensors.append(t)
    return tensors, dims, tile


def policy_mlp_cuda(x: torch.Tensor, eps: torch.Tensor, trunk, mu, value, log_std: torch.Tensor, scale: float):
    """Kernel P on the card, on inputs that meet ``kernel_args``'s contract,
    with autograd not recording."""
    if torch.is_grad_enabled():
        raise RuntimeError('the policy kernel has no backward: call it with autograd not recording '
                           '(torch.no_grad) or call policy_mlp_plain')
    if x.device.type != 'cuda':
        raise ValueError(f'policy_mlp_cuda needs CUDA tensors, got {x.device}')
    tensors, dims, tile = kernel_args(x, eps, trunk, mu, value, log_std)
    a, b = eps.shape
    out = torch.empty((2 * a + 2, b), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in tensors]
    ptrs.insert(2, out.data_ptr())
    with torch.cuda.device(x.device):
        err = build.lib().gprt_policy_mlp((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
                                          len(trunk), a, b, scale, tile, kernels.stream_ptr(out))
    build.check(err, 'policy_mlp')
    kernels.LAUNCHES['policy_mlp'] += 1
    action, raw, tail = out.split((a, a, 2))
    return action, raw, tail[0], tail[1]


@profiling.spanned(profiling.LAUNCH)
def policy_mlp(x: torch.Tensor, eps: torch.Tensor, trunk, mu, value, log_std: torch.Tensor, scale: float):
    """One policy step by the device of ``x`` and ``eps``: the plain version
    on the CPU, kernel P on the card."""
    if not kernels.on_cuda(x, eps):
        return policy_mlp_plain(x, eps, trunk, mu, value, log_std, scale)
    return policy_mlp_cuda(x, eps, trunk, mu, value, log_std, scale)
