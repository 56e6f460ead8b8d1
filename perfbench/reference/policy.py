"""Plain PyTorch reference of the actor-critic policy of the reactive cells.

A shared tanh trunk of ``hidden`` widths over the 12 features, a Gaussian
head ``mu`` with a state-free ``log_std`` and a value head, all in float32
with full-precision products (TF32 off).  Its weights come from one flat
float32 vector that the benchmark draws from the seed (``unpack``), the same
vector the program's policy is loaded from.

``tf32`` rounds the operands of every product to TF32 (10 mantissa bits, to
nearest) before a float32 product: the control, the precision one step
below the configuration's.
"""

from __future__ import annotations

import math

import torch

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def shapes(obs_dim: int, hidden: list, action_dim: int) -> list:
    """``(name, shape)`` of every leaf in the flat vector's order."""
    sizes = [obs_dim, *hidden]
    out = []
    for i in range(len(hidden)):
        out += [(f'trunk{i}.weight', (sizes[i + 1], sizes[i])), (f'trunk{i}.bias', (sizes[i + 1],))]
    out += [('mu.weight', (action_dim, sizes[-1])), ('mu.bias', (action_dim,)),
            ('value.weight', (1, sizes[-1])), ('value.bias', (1,)), ('log_std', (action_dim,))]
    return out


def unpack(flat: torch.Tensor, obs_dim: int, hidden: list, action_dim: int) -> dict:
    """The leaves of ``shapes`` as views of ``flat``."""
    out, i = {}, 0
    for name, shape in shapes(obs_dim, hidden, action_dim):
        n = math.prod(shape)
        out[name] = flat[i:i + n].view(shape)
        i += n
    if i != flat.numel():
        raise ValueError(f'the flat vector holds {flat.numel()} values, the policy {i}')
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return ((bits + 2**31) % 2**32 - 2**31).to(torch.int32).view(torch.float32)


def forward(w: dict, x: torch.Tensor, n_hidden: int, lower: bool = False):
    """Plane-major forward: features ``[F, B]`` -> ``(mu [A, B], log_std [A],
    value [B])``; ``lower`` takes the products in TF32."""
    rnd = tf32 if lower else (lambda t: t)
    for i in range(n_hidden):
        x = torch.tanh(w[f'trunk{i}.bias'][:, None] + rnd(w[f'trunk{i}.weight']) @ rnd(x))
    mu = w['mu.bias'][:, None] + rnd(w['mu.weight']) @ rnd(x)
    value = (w['value.bias'][:, None] + rnd(w['value.weight']) @ rnd(x))[0]
    return mu, w['log_std'], value


def sample(w: dict, x: torch.Tensor, eps: torch.Tensor, n_hidden: int, lower: bool = False):
    """``(raw action [A, B], log-prob [B], value [B])`` for exploration noise
    ``eps`` ``[A, B]``: ``raw = mu + exp(log_std) * eps``."""
    mu, log_std, value = forward(w, x, n_hidden, lower)
    std = torch.exp(log_std)[:, None]
    raw = mu + std * eps
    logp = (-0.5 * ((raw - mu) / std) ** 2 - log_std[:, None] - HALF_LOG_2PI).sum(0)
    return raw, logp, value
