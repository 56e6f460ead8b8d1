"""PPO learner (actor-critic MLP, GAE, clipped surrogate) in PyTorch.

Counterpart of ``gymnasium_planar_robotics_tpu/models/ppo.py``: the same
``PPOConfig``, initial distributions, losses and train steps.  The policy is
an ``nn.Module`` (``ActorCritic``); its weights cross over to and from the
JAX package's layout ``{'trunk': [{'w': [in, out], 'b'}], 'mu', 'value',
'log_std'}`` with ``params_from_numpy`` / ``params_to_numpy`` (``nn.Linear``
keeps ``[out, in]``).  ``optax.adam`` becomes ``torch.optim.Adam`` with the
same formula, ``jax.value_and_grad`` becomes autograd, and PRNG keys become
``torch.Generator``s.

The env kernels are never differentiated: the rollout runs under
``torch.no_grad()`` and only the policy sees gradients.  The policy runs in
float32 with PyTorch's default matmul precision (no TF32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.ops.kernels import policy as kpolicy
from gymnasium_planar_robotics_tpu_torch.parallel import sharding

_HALF_LOG_2PI = kpolicy.HALF_LOG_2PI
_HALF_LOG_2PIE = 0.5 * math.log(2 * math.pi * math.e)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    obs_dim: int
    action_dim: int
    hidden: tuple[int, ...] = (256, 256)
    action_scale: float = 10.0  # actions squashed to [-scale, scale]
    rollout_steps: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    learning_rate: float = 3e-4
    update_epochs: int = 4


class ActorCritic(nn.Module):
    """Shared tanh trunk, a Gaussian policy head ``mu`` with a state-free
    ``log_std``, and a value head; on ``device``, the card unless named."""

    def __init__(self, obs_dim: int, hidden: tuple[int, ...], action_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        sizes = (obs_dim, *hidden)
        kw = dict(dtype=dtype, device=common.resolve_device(device))
        self.trunk = nn.ModuleList(nn.Linear(sizes[i], sizes[i + 1], **kw) for i in range(len(hidden)))
        self.mu = nn.Linear(sizes[-1], action_dim, **kw)
        self.value = nn.Linear(sizes[-1], 1, **kw)
        self.log_std = nn.Parameter(torch.zeros(action_dim, **kw))

    def forward(self, obs: torch.Tensor):
        """``obs [..., F] -> (mu [..., A], log_std [A], value [...])``."""
        x = obs
        for layer in self.trunk:
            x = torch.tanh(layer(x))
        return self.mu(x), self.log_std, self.value(x)[..., 0]

    def forward_pm(self, x: torch.Tensor):
        """Plane-major ``forward``: ``x [F, B] -> (mu [A, B], log_std,
        value [B])``, the layout the kernels' feature planes come in."""
        trunk, mu_head, value_head, log_std = self.params_pm()
        mu, value = kpolicy.forward_plain(x, trunk, mu_head, value_head)
        return mu, log_std, value

    def params_pm(self):
        """``(trunk [(weight, bias)], (mu.weight, mu.bias), (value.weight,
        value.bias), log_std)``: the parameters themselves, as
        ``ops/kernels/policy`` takes them."""
        return ([(layer.weight, layer.bias) for layer in self.trunk], (self.mu.weight, self.mu.bias),
                (self.value.weight, self.value.bias), self.log_std)


def init_params(cfg: PPOConfig, generator: torch.Generator | None = None, dtype=torch.float32,
                device=None) -> ActorCritic:
    """A policy with the JAX package's initial distributions: trunk weights
    N(0, 2 / fan_in), ``mu`` weights N(0, 0.01^2), value weights N(0, 1),
    zero biases and ``log_std``.  On ``device``: the card unless named."""
    device = common.resolve_device(device)
    policy = ActorCritic(cfg.obs_dim, cfg.hidden, cfg.action_dim, dtype=dtype, device=device)
    gdev = generator.device if generator is not None else torch.device('cpu')

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=gdev, dtype=dtype) * scale).to(device)

    with torch.no_grad():
        for layer in policy.trunk:
            layer.weight.copy_(normal(layer.weight.shape, math.sqrt(2.0 / layer.in_features)))
            layer.bias.zero_()
        policy.mu.weight.copy_(normal(policy.mu.weight.shape, 0.01))
        policy.mu.bias.zero_()
        policy.value.weight.copy_(normal(policy.value.weight.shape, 1.0))
        policy.value.bias.zero_()
        policy.log_std.zero_()
    return policy


def params_from_numpy(tree: dict, device=None) -> ActorCritic:
    """A policy from weights in the JAX package's layout (numpy leaves, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``), on ``device`` (the card
    unless named)."""
    device = common.resolve_device(device)
    ws = [np.asarray(layer['w']) for layer in tree['trunk']]
    policy = ActorCritic(ws[0].shape[0], tuple(w.shape[1] for w in ws), np.asarray(tree['mu']['w']).shape[1],
                         dtype=torch.tensor(ws[0][:0]).dtype, device=device)

    def put(linear: nn.Linear, leaf: dict):
        linear.weight.copy_(torch.tensor(np.asarray(leaf['w']).T))
        linear.bias.copy_(torch.tensor(np.asarray(leaf['b'])))

    with torch.no_grad():
        for layer, leaf in zip(policy.trunk, tree['trunk']):
            put(layer, leaf)
        put(policy.mu, tree['mu'])
        put(policy.value, tree['value'])
        policy.log_std.copy_(torch.tensor(np.asarray(tree['log_std'])))
    return policy


def params_to_numpy(policy: ActorCritic) -> dict:
    """The policy's weights in the JAX package's layout, as numpy arrays."""

    def leaf(linear: nn.Linear) -> dict:
        return {'w': linear.weight.detach().cpu().numpy().T.copy(), 'b': linear.bias.detach().cpu().numpy()}

    return {'trunk': [leaf(layer) for layer in policy.trunk], 'mu': leaf(policy.mu), 'value': leaf(policy.value),
            'log_std': policy.log_std.detach().cpu().numpy()}


def apply(policy: ActorCritic, obs: torch.Tensor):
    """``(mu, log_std, value)``, batched over the leading dims of ``obs``."""
    return policy(obs)


def apply_pm(policy: ActorCritic, x: torch.Tensor):
    """Plane-major ``apply``: features ``[F, B]`` -> ``(mu [A, B], log_std,
    value [B])``."""
    return policy.forward_pm(x)


def _noise(noise_or_generator, shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Given standard normals, or ones of ``shape`` and ``dtype`` drawn from
    a generator (on the generator's device, then moved to ``device``), or
    from the default generator of ``device``."""
    if isinstance(noise_or_generator, torch.Tensor):
        return noise_or_generator
    gdev = noise_or_generator.device if noise_or_generator is not None else device
    return torch.randn(shape, generator=noise_or_generator, device=gdev, dtype=dtype).to(device)


def sample_action_pm(policy: ActorCritic, obs_pm: torch.Tensor, noise_or_generator, scale: float):
    """Plane-major ``sample_action``: ``obs_pm [F, B] -> (action [A, B], raw
    [A, B], logp [B], value [B])``; the exploration noise is given ``[A, B]``
    or drawn from a ``torch.Generator``.  On the card, one launch of kernel P
    (``ops/kernels/policy``), which has no backward: it raises with autograd
    recording, and a caller that differentiates the step calls
    ``policy_mlp_plain``.  On the CPU, its plain torch ops."""
    trunk, mu, value, log_std = policy.params_pm()
    eps = _noise(noise_or_generator, (mu[0].shape[0], obs_pm.shape[1]), log_std.dtype, obs_pm.device)
    # the kernel reads whole planes: a shard's noise is a strided view of the global draw
    return kpolicy.policy_mlp(obs_pm.contiguous(), eps.contiguous(), trunk, mu, value, log_std, scale)


def sample_action(policy: ActorCritic, obs: torch.Tensor, noise_or_generator, scale: float):
    """A Gaussian action: ``(clipped action, pre-clip raw sample, its
    log-prob, value)``.  The PPO ratio is taken on the raw sample; clipping
    only protects the env."""
    mu, log_std, value = apply(policy, obs)
    raw = mu + torch.exp(log_std) * _noise(noise_or_generator, mu.shape, mu.dtype, mu.device)
    return torch.clamp(raw, -scale, scale), raw, _gaussian_logp(raw, mu, log_std), value


def _gaussian_logp(x, mu, log_std):
    return (-0.5 * ((x - mu) / torch.exp(log_std)) ** 2 - log_std - _HALF_LOG_2PI).sum(-1)


class Transition(NamedTuple):
    obs: torch.Tensor  # [T, B, obs_dim]
    raw_action: torch.Tensor  # [T, B, A] pre-clip sample (the policy's own variable)
    logp: torch.Tensor  # [T, B]
    value: torch.Tensor  # [T, B]
    reward: torch.Tensor  # [T, B]
    terminated: torch.Tensor  # [T, B]
    truncated: torch.Tensor  # [T, B]
    final_value: torch.Tensor  # [T, B] V(final_observation), the bootstrap at truncations


def compute_gae(traj: Transition, last_value: torch.Tensor, gamma: float, lam: float):
    """GAE over a ``[T, B]`` trajectory, last step first.

    Truncation is not termination: a truncated step bootstraps with
    V(final_observation), a terminated one with 0; the advantage chain cuts
    at every episode boundary (the next state belongs to a new episode)."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    advantages = torch.empty_like(traj.value)
    for t in range(traj.value.shape[0] - 1, -1, -1):
        term = traj.terminated[t].to(traj.value.dtype)
        trunc = traj.truncated[t].to(traj.value.dtype)
        episode_continues = 1.0 - term - trunc + term * trunc  # 1 - (term | trunc)
        bootstrap = (1.0 - term) * torch.where(traj.truncated[t], traj.final_value[t], next_value)
        delta = traj.reward[t] + gamma * bootstrap - traj.value[t]
        gae = delta + gamma * lam * episode_continues * gae
        advantages[t] = gae
        next_value = traj.value[t]
    return advantages, advantages + traj.value


def ppo_loss(policy: ActorCritic, cfg: PPOConfig, batch, adv_moments=None) -> torch.Tensor:
    """Clipped-surrogate PPO loss (policy + value + entropy terms) over
    ``(obs, raw_action, old_logp, advantages, returns)``.  The advantages are
    normalised by their population std (``correction=0``), as ``jnp.std``,
    or by ``adv_moments = (mean, std)`` when given (the global batch's, over
    a mesh)."""
    obs, raw_action, old_logp, advantages, returns = batch
    mu, log_std, value = apply(policy, obs)
    ratio = torch.exp(_gaussian_logp(raw_action, mu, log_std) - old_logp)
    mean, std = (advantages.mean(), advantages.std(correction=0)) if adv_moments is None else adv_moments
    adv = (advantages - mean) / (std + 1e-8)
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
    v_loss = ((value - returns) ** 2).mean()
    entropy = (log_std + _HALF_LOG_2PIE).sum()
    return pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy


def make_optimizer(cfg: PPOConfig) -> Callable[[ActorCritic], torch.optim.Adam]:
    """``policy -> torch.optim.Adam`` with ``optax.adam``'s defaults (betas
    0.9 / 0.999, eps 1e-8 outside the root): the same update formula."""
    return lambda policy: torch.optim.Adam(policy.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _global_moments(advantages: torch.Tensor, mesh):
    """The mean and population std of the advantages over every rank's
    shard (equal shards), from one ``all_reduce`` of float64 sums."""
    a = advantages.to(torch.float64)
    mean, sq = sharding.all_reduce_mean(torch.stack([a.mean(), (a * a).mean()]), mesh).unbind()
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))
    return mean.to(advantages.dtype), std.to(advantages.dtype)


def _all_reduce_grads(policy: ActorCritic, mesh) -> None:
    """Every parameter's gradient averaged over the ranks, in one
    ``all_reduce`` of their concatenation: the gradient of the global batch's
    loss, the same on every rank, so Adam keeps the parameters equal."""
    grads = [p.grad for p in policy.parameters()]
    flat = sharding.all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _update(policy: ActorCritic, optimizer, cfg: PPOConfig, flat, mesh=None) -> torch.Tensor:
    """``update_epochs`` full-batch Adam steps on ``ppo_loss``; the last loss.
    With ``mesh``, ``flat`` is this rank's shard: the advantages are
    normalised by the global batch's moments and the gradients averaged over
    the ranks after ``backward``, before Adam."""
    moments = None if mesh is None else _global_moments(flat[3], mesh)
    for _ in range(cfg.update_epochs):
        optimizer.zero_grad(set_to_none=True)
        loss = ppo_loss(policy, cfg, flat, moments)
        loss.backward()
        if mesh is not None:
            _all_reduce_grads(policy, mesh)
        optimizer.step()
    return loss.detach()


def _flatten(traj: Transition, advantages, returns):
    return tuple(x.reshape((-1,) + tuple(x.shape[2:])) for x in (traj.obs, traj.raw_action, traj.logp, advantages,
                                                                 returns))


def _metrics(loss, traj: Transition, mesh=None) -> dict:
    """``loss``, ``reward_mean``, ``done_rate``; with ``mesh`` the global
    means, in one ``all_reduce``."""
    vals = torch.stack([loss, traj.reward.mean(), (traj.terminated | traj.truncated).to(torch.float32).mean()])
    if mesh is not None:
        vals = sharding.all_reduce_mean(vals, mesh)
    return dict(zip(('loss', 'reward_mean', 'done_rate'), vals.unbind()))


def _global_normals(shape: tuple, generator, device, mesh, dim: int, default_device=None) -> torch.Tensor:
    """Standard normals ``shape`` on ``device`` for this rank's shard along
    ``dim``: drawn for the global batch from ``generator`` (the same on every
    rank; without one, from ``default_device``'s default generator, else
    ``device``'s) and this rank's part taken, as the JAX package draws them
    for the global batch and shards them; without a mesh, drawn as they are."""
    n, r = (1, 0) if mesh is None else (mesh.size(), mesh.get_local_rank())
    full = list(shape)
    full[dim] *= n
    gdev = generator.device if generator is not None else torch.device(default_device or device)
    eps = torch.randn(full, generator=generator, device=gdev, dtype=torch.float32)
    return eps.narrow(dim, r * shape[dim], shape[dim]).to(device)


def make_train_step_reactive(cfg: PPOConfig, make_rollout, mesh=None):
    """PPO train step over a plane-form reactive rollout
    (``models/*.make_reactive_rollout``): the env state stays in the
    kernels' plane layout for the whole rollout, and the policy runs between
    kernel launches on the feature planes the kernels emit.

    ``make_rollout(policy_step)`` returns the reactive rollout built with
    ``num_steps=cfg.rollout_steps``, e.g.::

        train_step, make_opt = ppo.make_train_step_reactive(
            cfg, lambda ps: pushing.make_reactive_rollout(
                config, params, ps, cfg.rollout_steps, dense_reward=True))
        runner = (state, policy, make_opt(policy), generator, 0)
        runner, metrics = train_step(runner)

    Returns ``(train_step, make_optimizer)``.  The runner is ``(env_state,
    policy, optimizer, generator, seed)``: ``seed`` keys the kernels' Philox
    streams and advances by ``rollout_steps`` per iteration; the exploration
    noise ``[T, A, B]`` is drawn from ``generator`` once per iteration, or
    given as ``train_step(runner, eps=...)``.  The policy and the optimizer
    are updated in place.  Metrics are 0-dim tensors: ``loss`` (last
    epoch), ``reward_mean``, ``done_rate``.

    With ``mesh`` (``parallel/sharding.make_mesh``), ``make_rollout`` builds
    a sharded rollout (``sharding.make_sharded_reactive_rollout``) and the
    runner's state is this rank's shard: the noise is drawn for the global
    batch and sliced, the gradients are averaged over the ranks before each
    Adam step, and the metrics are the global means."""

    def policy_step(policy, noise_or_generator, obs_pm):
        # plane-major: features [F, B] in, actions [A, B] out
        action, raw, logp, value = sample_action_pm(policy, obs_pm, noise_or_generator, cfg.action_scale)
        return action, (raw, logp, value)

    reactive_rollout = make_rollout(policy_step)

    def train_step(runner, eps: torch.Tensor | None = None):
        env_state, policy, optimizer, generator, seed = runner
        device = env_state.pos.device
        if eps is None:
            eps = _global_normals((cfg.rollout_steps, cfg.action_dim, env_state.pos.shape[0]), generator, device,
                                  mesh, 2, default_device='cpu')
        with torch.no_grad():
            env_state, traj_t, last_obs_vec = reactive_rollout(env_state, policy, generator, seed, policy_xs=eps)
            obs_vec, (raw, logp, value), reward, term, trunc, final_vec = traj_t
            _, _, last_value = apply(policy, last_obs_vec)
            _, _, final_value = apply(policy, final_vec)
            traj = Transition(obs=obs_vec, raw_action=raw, logp=logp, value=value, reward=reward.to(torch.float32),
                              terminated=term, truncated=trunc, final_value=final_value)
            advantages, returns = compute_gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        loss = _update(policy, optimizer, cfg, _flatten(traj, advantages, returns), mesh)
        return (env_state, policy, optimizer, generator, seed + cfg.rollout_steps), _metrics(loss, traj, mesh)

    train_step.policy_step = policy_step
    return train_step, make_optimizer(cfg)


def make_train_step(
    env_config,
    env_params,
    cfg: PPOConfig,
    step_autoreset_fn: Callable | None = None,
    obs_to_vec: Callable | None = None,
    batched_step_fn: Callable | None = None,
    mesh=None,
):
    """``train_step(runner, eps=None) -> (runner, metrics)``: one rollout of
    ``cfg.rollout_steps`` batched env steps, then the PPO updates.

    Pass either ``step_autoreset_fn(config, params, state, action,
    generator=...)``, an eager autoreset step such as
    ``pushing.step_autoreset`` (batched: the JAX package vmaps its per-env
    step here), which draws its noise from the runner's generator, or
    ``batched_step_fn(state, action)``, an already-batched autoreset step
    such as a ``make_fused_step_autoreset`` of the port.  The runner is
    ``(env_state, obs_vec, policy, optimizer, generator)``; the exploration
    noise ``[T, B, A]`` is drawn from ``generator`` step by step, or given
    as ``eps``.  ``train_step.collect`` and ``train_step.update`` are its
    two parts, the rollout and the PPO epochs.  Returns ``(train_step,
    make_optimizer)``.

    With ``mesh``, ``batched_step_fn`` is a sharded step
    (``sharding.make_sharded_fused_step``) and the runner's state and
    observations are this rank's shard: each step's noise is drawn for the
    global batch and sliced, the gradients are averaged over the ranks
    before each Adam step (the JAX package gets this all-reduce from the
    shardings under ``jit``), and the metrics are the global means."""
    if batched_step_fn is None and step_autoreset_fn is None:
        raise ValueError('pass step_autoreset_fn or batched_step_fn')

    if obs_to_vec is None:
        def obs_to_vec(obs):
            return torch.cat([obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1).to(torch.float32)

    def env_step(state, action, generator):
        if batched_step_fn is not None:
            return batched_step_fn(state, action)
        return step_autoreset_fn(env_config, env_params, state, action, generator=generator)

    def collect(env_state, obs_vec, policy, generator, eps: torch.Tensor | None = None):
        """The rollout of a train step and its GAE, under ``no_grad``:
        ``(env_state, obs_vec, traj, advantages, returns)``."""
        steps = []
        with torch.no_grad():
            for t in range(cfg.rollout_steps):
                if eps is not None:
                    noise = eps[t]
                elif mesh is not None:
                    noise = _global_normals((obs_vec.shape[0], cfg.action_dim), generator, obs_vec.device, mesh, 0)
                else:
                    noise = generator
                action, raw, logp, value = sample_action(policy, obs_vec, noise, cfg.action_scale)
                env_state, obs, reward, terminated, truncated, info = env_step(env_state, action, generator)
                _, _, final_value = apply(policy, obs_to_vec(info['final_observation']))
                steps.append(Transition(obs=obs_vec, raw_action=raw, logp=logp, value=value,
                                        reward=reward.to(torch.float32), terminated=terminated, truncated=truncated,
                                        final_value=final_value))
                obs_vec = obs_to_vec(obs)
            traj = Transition(*(torch.stack(leaf) for leaf in zip(*steps)))
            _, _, last_value = apply(policy, obs_vec)
            advantages, returns = compute_gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        return env_state, obs_vec, traj, advantages, returns

    def update(policy, optimizer, traj, advantages, returns):
        """The PPO epochs on one rollout; the last loss."""
        return _update(policy, optimizer, cfg, _flatten(traj, advantages, returns), mesh)

    def train_step(runner, eps: torch.Tensor | None = None):
        env_state, obs_vec, policy, optimizer, generator = runner
        env_state, obs_vec, traj, advantages, returns = collect(env_state, obs_vec, policy, generator, eps)
        loss = update(policy, optimizer, traj, advantages, returns)
        return (env_state, obs_vec, policy, optimizer, generator), _metrics(loss, traj, mesh)

    train_step.collect, train_step.update = collect, update
    return train_step, make_optimizer(cfg)
