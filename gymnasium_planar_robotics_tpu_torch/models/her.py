"""Hindsight Experience Replay on sparse rewards (DDPG / TD3), in PyTorch.

Counterpart of ``gymnasium_planar_robotics_tpu/models/her.py``: the same
``HERConfig``, networks, initial distributions, relabelling, n-step backups,
replay buffer, losses and train step.  One iteration

1. rolls the batched env ``T`` steps with exploration noise (the fused
   autoreset step of either family, or the eager ``step_autoreset``),
2. relabels goals with the 'future' strategy inside the rollout window (per
   (env, t), a uniformly drawn future step of the same episode donates its
   achieved goal; reward and termination are recomputed by the family's
   ``compute_reward``),
3. runs DDPG/TD3 updates (actor, critic, Polyak targets) on the original and
   relabelled transitions, from the replay buffer or the window.

The networks are ``nn.Module``s (``HERNets``); their weights cross over to
and from the JAX package's params pytree (lists of ``{'w': [in, out],
'b'}`` layers, a twin critic a list of two) with ``params_from_numpy`` /
``params_to_numpy``.  ``optax.adam`` becomes ``torch.optim.Adam`` with the
same formula, ``jax.value_and_grad`` autograd, PRNG keys a
``torch.Generator``.  The matrix products are ``nn.Linear`` in full float32,
as the JAX package leaves them to XLA outside any kernel: ``make_train_step``
sets the float32 matmul precision to 'highest' (no TF32).

Everything stays on the device of the env state: the rollout, the
relabelling, the buffer and the updates read nothing back to the host.  The
buffer's ``ptr`` and ``filled`` are host ints (they follow from the counts
inserted), and the buffer is written in place (the JAX package returns a new
one): at 4M transitions it holds ~460 MB.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from gymnasium_planar_robotics_tpu_torch.models import common


@dataclasses.dataclass(frozen=True)
class HERConfig:
    obs_dim: int  # non-goal observation width
    goal_dim: int
    action_dim: int
    hidden: tuple[int, ...] = (128, 128)
    action_scale: float = 3.0
    rollout_steps: int = 16
    gamma: float = 0.95
    tau: float = 0.05
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    relabel_prob: float = 0.8
    explore_std: float = 0.3
    explore_eps: float = 0.3  # fraction of fully random actions
    reward_scale: float = 0.02  # the critic trains on r * scale (sparse +-50 -> +-1)
    update_steps: int = 10
    #: transitions kept in the circular replay buffer; 0: train on the
    #: current rollout window only
    replay_size: int = 0
    minibatch: int = 4096  # replay minibatch per update step
    #: actor loss += action_l2 * mean((a / scale)^2)
    action_l2: float = 0.0
    #: TD3 clipped double-Q: two critics, the backup takes min(Q1', Q2')
    twin_critic: bool = False
    #: target policy smoothing: clipped Gaussian noise (std as a fraction of
    #: action_scale) on the backup's action
    target_noise: float = 0.0
    noise_clip: float = 0.5
    #: actor and target update every k-th critic update (TD3 delayed policy)
    policy_delay: int = 1
    #: n-step Bellman targets, cut at episode ends, at (relabelled)
    #: termination and at the window's end
    n_step: int = 1
    #: the random-action coin and direction held for a whole episode
    #: (redrawn at autoreset boundaries and, as in the JAX package, at every
    #: rollout window's start)
    explore_per_episode: bool = False


class MLP(nn.Module):
    """tanh between the linear layers, none after the last."""

    def __init__(self, sizes: tuple, dtype=torch.float32, device=None):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(sizes[i], sizes[i + 1], dtype=dtype, device=device)
                                    for i in range(len(sizes) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x


class HERNets(nn.Module):
    """The actor, the critic heads (one, or two for TD3), and their Polyak
    target copies (no gradients)."""

    def __init__(self, in_dim: int, hidden: tuple, action_dim: int, heads: int, dtype=torch.float32, device=None):
        super().__init__()
        self.actor = MLP((in_dim, *hidden, action_dim), dtype, device)
        self.critic = nn.ModuleList(MLP((in_dim + action_dim, *hidden, 1), dtype, device) for _ in range(heads))
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)


def init_params(cfg: HERConfig, generator: torch.Generator | None = None, device=None) -> HERNets:
    """Actor and critic(s) with the JAX package's initial distributions
    (weights N(0, 2 / fan_in), the last layer's N(0, 0.01^2) for the actor
    and N(0, 1) for the critic; zero biases), the targets their copies.  On
    ``device``: the card unless named."""
    device = common.resolve_device(device)
    in_dim = cfg.obs_dim + 2 * cfg.goal_dim
    nets = HERNets(in_dim, tuple(cfg.hidden), cfg.action_dim, 2 if cfg.twin_critic else 1, device=device)
    gdev = generator.device if generator is not None else torch.device('cpu')

    def init(mlp: MLP, out_scale: float):
        for i, layer in enumerate(mlp.layers):
            scale = out_scale if i == len(mlp.layers) - 1 else math.sqrt(2.0 / layer.in_features)
            w = torch.randn((layer.in_features, layer.out_features), generator=generator, device=gdev) * scale
            layer.weight.copy_(w.T.to(device))
            layer.bias.zero_()

    with torch.no_grad():
        init(nets.actor, 0.01)
        for head in nets.critic:
            init(head, 1.0)
    nets.actor_target.load_state_dict(nets.actor.state_dict())
    nets.critic_target.load_state_dict(nets.critic.state_dict())
    return nets


def _layers_from(mlp: MLP, tree: list) -> None:
    for layer, leaf in zip(mlp.layers, tree):
        layer.weight.copy_(torch.tensor(np.asarray(leaf['w']).T))
        layer.bias.copy_(torch.tensor(np.asarray(leaf['b'])))


def _heads(critic_tree: list) -> list:
    """A single critic is a list of layer dicts, a twin one a list of two."""
    return critic_tree if isinstance(critic_tree[0], list) else [critic_tree]


def params_from_numpy(tree: dict, device=None) -> HERNets:
    """Networks from the JAX package's params pytree (numpy leaves), on
    ``device`` (the card unless named)."""
    device = common.resolve_device(device)
    ws = [np.asarray(layer['w']) for layer in tree['actor']]
    nets = HERNets(ws[0].shape[0], tuple(w.shape[1] for w in ws[:-1]), ws[-1].shape[1], len(_heads(tree['critic'])),
                   dtype=torch.tensor(ws[0][:0]).dtype, device=device)
    with torch.no_grad():
        _layers_from(nets.actor, tree['actor'])
        _layers_from(nets.actor_target, tree['actor_target'])
        for head, leaf in zip(nets.critic, _heads(tree['critic'])):
            _layers_from(head, leaf)
        for head, leaf in zip(nets.critic_target, _heads(tree['critic_target'])):
            _layers_from(head, leaf)
    return nets


def params_to_numpy(nets: HERNets) -> dict:
    """The networks in the JAX package's params layout, as numpy arrays."""

    def layers(mlp: MLP) -> list:
        return [{'w': layer.weight.detach().cpu().numpy().T.copy(), 'b': layer.bias.detach().cpu().numpy()}
                for layer in mlp.layers]

    def critic(heads) -> list:
        out = [layers(h) for h in heads]
        return out if len(out) > 1 else out[0]

    return {'actor': layers(nets.actor), 'critic': critic(nets.critic), 'actor_target': layers(nets.actor_target),
            'critic_target': critic(nets.critic_target)}


def actor_action(actor: MLP, obs_vec: torch.Tensor, scale: float) -> torch.Tensor:
    """Deterministic policy: the tanh-squashed MLP output scaled to the
    action limit."""
    return torch.tanh(actor(obs_vec)) * scale


def critic_q(critic: nn.ModuleList, obs_vec: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Q(s, a); for a twin critic the first head, the one the actor
    ascends."""
    return critic[0](torch.cat([obs_vec, action], -1))[..., 0]


def episode_end_indices(done: torch.Tensor) -> torch.Tensor:
    """``[T, B]`` done flags -> ``[T, B]`` int64 index of each step's episode
    end within the window (the first t' >= t with done[t'], else T - 1)."""
    T = done.shape[0]
    ends = torch.empty(done.shape, dtype=torch.int64, device=done.device)
    end = torch.full(done.shape[1:], T - 1, dtype=torch.int64, device=done.device)
    for t in range(T - 1, -1, -1):
        end = torch.where(done[t], t, end)
        ends[t] = end
    return ends


def relabel_future(done: torch.Tensor, next_achieved: torch.Tensor, desired: torch.Tensor, relabel_prob: float,
                   generator: torch.Generator | None = None, draws: tuple | None = None):
    """'Future' HER relabelling over a ``[T, B]`` window: per transition,
    with probability ``relabel_prob``, the desired goal is replaced by the
    achieved goal of a uniformly chosen step in [t, episode end].  ``draws``
    ``(u, p)``, two ``[T, B]`` uniforms (the donor's position and the coin),
    or drawn from ``generator``.  Returns ``(new desired, used)``."""
    T, B = done.shape
    ends = episode_end_indices(done)
    u, p = draws if draws is not None else _uniforms((2, T, B), generator, done.device)
    ts = torch.arange(T, device=done.device)[:, None]
    span = (ends - ts + 1).to(torch.float32)
    future = torch.clamp(ts + torch.floor(u * span).to(torch.int64), 0, T - 1)
    donor = torch.gather(next_achieved, 0, future[..., None].expand(-1, -1, next_achieved.shape[-1]))
    use = p < relabel_prob
    return torch.where(use[..., None], donor, desired), use


def nstep_backup(n: int, gamma: float, done: torch.Tensor, reward_at, term_at, snext_at):
    """Per-transition n-step backup pieces over a ``[T, B]`` window.

    ``reward_at(k)``: ``[T, B]`` reward of step t + k judged against
    transition t's goal; ``term_at(k)`` its termination flag; ``snext_at(k)``
    the bootstrap state vector of step t + k.  Chains cut at episode ends
    (``done``), at goal-judged termination and at the window's end.  Returns
    ``(R_n, s_next_n, not_term_n, disc_n)`` with ``R_n[t] = sum_{k < n_eff}
    gamma^k r_{t+k}`` and ``disc_n = gamma^n_eff``."""
    T = done.shape[0]
    is_last = (torch.arange(T, device=done.device) == T - 1)[:, None] & torch.ones_like(done)
    zero = torch.zeros(done.shape, dtype=torch.float32, device=done.device)
    racc, alive = zero, torch.ones_like(done)
    s_next_n = torch.zeros_like(snext_at(0))
    nt_n, disc_n = zero, zero
    for k in range(n):
        r_k = reward_at(k)
        term_k = term_at(k)
        racc = racc + torch.where(alive, (gamma ** k) * r_k, 0.0)
        stop = _shift(done, k) | term_k | _shift(is_last, k) | (k == n - 1)
        final_here = alive & stop
        s_next_n = torch.where(final_here[..., None], snext_at(k), s_next_n)
        nt_n = torch.where(final_here, 1.0 - term_k.to(torch.float32), nt_n)
        disc_n = torch.where(final_here, gamma ** (k + 1), disc_n)
        alive = alive & ~stop
    return racc, s_next_n, nt_n, disc_n


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[t + k] along the window axis, zero-padded past the end (never read:
    every chain stops at the window's end)."""
    if k == 0:
        return x
    return torch.cat([x[k:], torch.zeros((k,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])


# ---------------------------------------------------------------------------
# replay buffer
# ---------------------------------------------------------------------------

REPLAY_FIELDS = ('s', 'a', 'r', 's_next', 'not_term', 'disc')


def init_replay(cfg: HERConfig, device=None) -> dict:
    """A zeroed circular replay buffer on ``device`` (the card unless
    named): ``s``, ``a``, ``r``, ``s_next``, ``not_term``, ``disc`` (the
    per-sample bootstrap discount gamma^n_eff) tensors, and the host ints
    ``ptr`` (the next slot) and ``filled``."""
    device = common.resolve_device(device)
    d, n = cfg.obs_dim + 2 * cfg.goal_dim, cfg.replay_size
    z = dict(dtype=torch.float32, device=device)
    return {'s': torch.zeros((n, d), **z), 'a': torch.zeros((n, cfg.action_dim), **z), 'r': torch.zeros((n,), **z),
            's_next': torch.zeros((n, d), **z), 'not_term': torch.zeros((n,), **z), 'disc': torch.zeros((n,), **z),
            'ptr': 0, 'filled': 0}


def _replay_insert(buf: dict, batch: tuple) -> dict:
    """Write ``batch`` (``REPLAY_FIELDS`` order) at ``ptr``, wrapping around,
    in place; returns the buffer."""
    n, m = buf['s'].shape[0], batch[0].shape[0]
    if m > n:
        raise ValueError(f'{m} transitions a window do not fit a replay buffer of {n}')
    ptr = buf['ptr']
    head = min(m, n - ptr)
    for name, x in zip(REPLAY_FIELDS, batch):
        buf[name][ptr:ptr + head] = x[:head]
        buf[name][:m - head] = x[head:]
    buf['ptr'] = (ptr + m) % n
    buf['filled'] = min(buf['filled'] + m, n)
    return buf


def _replay_sample(buf: dict, minibatch: int, generator: torch.Generator | None = None,
                   idx: torch.Tensor | None = None) -> tuple:
    """A uniform minibatch of the filled part: rows ``idx``, or ``minibatch``
    indices drawn from ``generator``."""
    if idx is None:
        gdev = generator.device if generator is not None else buf['s'].device
        idx = torch.randint(0, max(buf['filled'], 1), (minibatch,), generator=generator,
                            device=gdev).to(buf['s'].device)
    return tuple(buf[name][idx] for name in REPLAY_FIELDS)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _uniforms(shape, generator, device) -> torch.Tensor:
    gdev = generator.device if generator is not None else torch.device(device)
    return torch.rand(shape, generator=generator, device=gdev, dtype=torch.float32).to(device)


def make_optimizers(cfg: HERConfig) -> Callable[[HERNets], tuple]:
    """``nets -> (actor Adam, critic Adam)`` with ``optax.adam``'s defaults
    (betas 0.9 / 0.999, eps 1e-8 outside the root)."""

    def make(nets: HERNets):
        return (torch.optim.Adam(nets.actor.parameters(), lr=cfg.actor_lr, betas=(0.9, 0.999), eps=1e-8),
                torch.optim.Adam(nets.critic.parameters(), lr=cfg.critic_lr, betas=(0.9, 0.999), eps=1e-8))

    return make


def critic_loss(nets: HERNets, cfg: HERConfig, batch: tuple, target_noise: torch.Tensor | None) -> torch.Tensor:
    """The Bellman loss summed over the critic heads; ``target_noise`` the
    standard normals of the backup's smoothing (with ``cfg.target_noise``)."""
    s, a, r, s_next, not_term, disc = batch
    scale = cfg.action_scale
    with torch.no_grad():
        a_next = actor_action(nets.actor_target, s_next, scale)
        if cfg.target_noise > 0.0:
            eps = torch.clamp(cfg.target_noise * target_noise, -cfg.noise_clip, cfg.noise_clip) * scale
            a_next = torch.clamp(a_next + eps, -scale, scale)
        x_next = torch.cat([s_next, a_next], -1)
        q_nexts = [head(x_next)[..., 0] for head in nets.critic_target]
        # clipped double-Q: the backup bootstraps from the pessimistic head
        q_next = q_nexts[0] if len(q_nexts) == 1 else torch.minimum(*q_nexts)
        # scaled rewards, the target clipped into the feasible return range
        y = r * cfg.reward_scale + disc * not_term * q_next
        lim = 50.0 * cfg.reward_scale / (1.0 - cfg.gamma)
        y = torch.clamp(y, -lim, lim)
    x = torch.cat([s, a], -1)
    return sum(((head(x)[..., 0] - y) ** 2).mean() for head in nets.critic)


def actor_loss(nets: HERNets, cfg: HERConfig, s: torch.Tensor) -> torch.Tensor:
    a = actor_action(nets.actor, s, cfg.action_scale)
    reg = cfg.action_l2 * torch.mean((a / cfg.action_scale) ** 2)
    return -critic_q(nets.critic, s, a).mean() + reg


def _polyak(nets: HERNets, tau: float) -> None:
    with torch.no_grad():
        for t, o in ((nets.actor_target, nets.actor), (nets.critic_target, nets.critic)):
            for pt, po in zip(t.parameters(), o.parameters()):
                pt.copy_((1 - tau) * pt + tau * po)


def make_train_step(
    env_config,
    env_params,
    cfg: HERConfig,
    step_autoreset_fn: Callable | None,
    compute_reward_fn: Callable,
    terminated_fn: Callable,
    vec_fn: Callable | None = None,
    batched_step_fn: Callable | None = None,
):
    """Build ``train_step(runner, draws=None) -> (runner, metrics)``.

    ``compute_reward_fn(achieved, desired, mover_col, wall_col)`` and
    ``terminated_fn(reward)`` are the family's relabelling surface
    (planning: ``|r| == 50``; pushing: ``r == -50``).  ``vec_fn(obs_part,
    achieved, desired) -> [.., D]`` optionally replaces the plain concat
    network input; ``cfg.obs_dim + 2 * cfg.goal_dim`` must equal D.

    Pass either ``step_autoreset_fn(config, params, state, action,
    generator=...)``, an eager autoreset step (batched; the JAX package vmaps
    its per-env step here) that draws from the runner's generator, or
    ``batched_step_fn(state, action)``, an already-batched step such as a
    ``make_fused_step_autoreset`` of the port (bind its generator).

    The runner is ``(env_state, obs, nets, actor_opt, critic_opt, buffer,
    generator)`` with a replay buffer (``cfg.replay_size > 0``), else
    without ``buffer``; the networks, optimizers and buffer are updated in
    place.  Every random number comes from ``generator`` or, for the parity
    tests, from ``draws``: ``explore_coin`` ``[B]`` and ``explore_held``
    ``[B, A]`` (the window's episode coin uniforms and held actions),
    ``noise`` ``[T, B, A]`` (standard normals), ``coin`` ``[T, B]``
    (uniforms), ``rand_a`` ``[T, B, A]`` (random actions), ``relabel``
    ``(u, p)``, ``sample_idx`` ``[U, minibatch]`` and ``target_noise``
    ``[U, minibatch, A]``.  Metrics are 0-dim tensors (no host
    synchronisation).  ``train_step.collect``, ``.relabel`` and ``.update``
    are its three parts.  Sets the process's float32 matmul precision to
    'highest'.  Returns ``(train_step, make_optimizers)``."""
    if batched_step_fn is None and step_autoreset_fn is None:
        raise ValueError('pass step_autoreset_fn or batched_step_fn')
    torch.set_float32_matmul_precision('highest')  # full float32 products, no TF32
    scale = cfg.action_scale

    def env_step(state, action, generator):
        if batched_step_fn is not None:
            return batched_step_fn(state, action)
        return step_autoreset_fn(env_config, env_params, state, action, generator=generator)

    if vec_fn is not None:
        vec = vec_fn
    else:
        def vec(obs_part, achieved, desired):
            return torch.cat([obs_part, achieved, desired], -1).to(torch.float32)

    def draw(draws, name, t, shape, kind, generator, device):
        if draws is not None:
            x = draws[name]
            return x if t is None else x[t]
        if kind == 'normal':
            return common.normals(shape, torch.float32, device, generator)
        u = _uniforms(shape, generator, device)
        return u if kind == 'uniform' else u * (2 * scale) - scale

    def collect(env_state, obs, nets, generator, draws=None):
        """The rollout under ``no_grad``: ``(env_state, obs, traj)``, traj a
        dict of ``[T, ...]`` stacks."""
        b = obs['achieved_goal'].shape[0]
        device = obs['achieved_goal'].device
        a_shape = (b, cfg.action_dim)
        # the episode-exploration carry, drawn at the window's start
        ep_rand = draw(draws, 'explore_coin', None, (b,), 'uniform', generator, device) < cfg.explore_eps
        ep_a = draw(draws, 'explore_held', None, a_shape, 'action', generator, device)
        steps = []
        with torch.no_grad():
            for t in range(cfg.rollout_steps):
                noise = draw(draws, 'noise', t, a_shape, 'normal', generator, device)
                coin = draw(draws, 'coin', t, (b,), 'uniform', generator, device) < cfg.explore_eps
                rand_a = draw(draws, 'rand_a', t, a_shape, 'action', generator, device)
                a = actor_action(nets.actor, vec(obs['observation'], obs['achieved_goal'], obs['desired_goal']),
                                 scale)
                a = torch.clamp(a + (cfg.explore_std * scale) * noise, -scale, scale)
                if cfg.explore_per_episode:
                    a = torch.where(ep_rand[:, None], ep_a, a)
                else:
                    a = torch.where(coin[:, None], rand_a, a)
                env_state, next_obs, reward, terminated, truncated, info = env_step(env_state, a, generator)
                if cfg.explore_per_episode:
                    # the episode's coin and direction redrawn where it ended
                    ep_done = terminated | truncated
                    ep_rand = torch.where(ep_done, coin, ep_rand)
                    ep_a = torch.where(ep_done[:, None], rand_a, ep_a)
                fin = info['final_observation']
                steps.append(dict(
                    obs_part=obs['observation'], achieved=obs['achieved_goal'], desired=obs['desired_goal'],
                    action=a, next_obs_part=fin['observation'], next_achieved=fin['achieved_goal'],
                    reward=reward.to(torch.float32), terminated=terminated, truncated=truncated,
                    mover_col=info['mover_collision'], wall_col=info['wall_collision'], success=info['is_success'],
                ))
                obs = next_obs
            traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        return env_state, obs, traj

    def relabel(traj, generator, draws=None):
        """The relabelled window and the transitions to train on:
        ``(batch, info)``, ``batch`` in ``REPLAY_FIELDS`` order (originals,
        then their relabelled copies), ``info`` what the metrics read."""
        with torch.no_grad():
            done = traj['terminated'] | traj['truncated']
            new_desired, used = relabel_future(done, traj['next_achieved'], traj['desired'], cfg.relabel_prob,
                                               generator, None if draws is None else draws['relabel'])
            new_reward = compute_reward_fn(traj['next_achieved'], new_desired, traj['mover_col'],
                                           traj['wall_col']).to(torch.float32)
            new_term = terminated_fn(new_reward)

            def flat2(x):
                return x.reshape((-1,) + tuple(x.shape[2:]))

            if cfg.n_step > 1:
                r_o, sn_o, nt_o, d_o = nstep_backup(
                    cfg.n_step, cfg.gamma, done,
                    lambda k: _shift(traj['reward'], k),
                    lambda k: _shift(traj['terminated'], k),
                    lambda k: vec(_shift(traj['next_obs_part'], k), _shift(traj['next_achieved'], k),
                                  traj['desired']),
                )

                def rel_reward(k):
                    return compute_reward_fn(_shift(traj['next_achieved'], k), new_desired,
                                             _shift(traj['mover_col'], k),
                                             _shift(traj['wall_col'], k)).to(torch.float32)

                r_r, sn_r, nt_r, d_r = nstep_backup(
                    cfg.n_step, cfg.gamma, done, rel_reward, lambda k: terminated_fn(rel_reward(k)),
                    lambda k: vec(_shift(traj['next_obs_part'], k), _shift(traj['next_achieved'], k), new_desired),
                )
            else:
                gm = torch.full(done.shape, cfg.gamma, dtype=torch.float32, device=done.device)
                r_o, sn_o = traj['reward'], vec(traj['next_obs_part'], traj['next_achieved'], traj['desired'])
                nt_o, d_o = 1.0 - traj['terminated'].to(torch.float32), gm
                r_r, sn_r = new_reward, vec(traj['next_obs_part'], traj['next_achieved'], new_desired)
                nt_r, d_r = 1.0 - new_term.to(torch.float32), gm

            # originals + relabelled copies (the standard HER buffer mix)
            s = torch.cat([flat2(vec(traj['obs_part'], traj['achieved'], traj['desired'])),
                           flat2(vec(traj['obs_part'], traj['achieved'], new_desired))])
            batch = (s, torch.cat([flat2(traj['action'])] * 2), torch.cat([flat2(r_o), flat2(r_r)]),
                     torch.cat([flat2(sn_o), flat2(sn_r)]), torch.cat([flat2(nt_o), flat2(nt_r)]),
                     torch.cat([flat2(d_o), flat2(d_r)]))
        return batch, {'done': done, 'used': used, 'new_reward': new_reward}

    def update(nets, actor_opt, critic_opt, batch, buffer, generator, draws=None):
        """``cfg.update_steps`` critic steps (the actor and the targets every
        ``policy_delay``-th) on replay minibatches, or on ``batch`` without
        a buffer: the last ``(critic loss, actor loss)``, the actor loss 0.0
        on a step that skips the actor, as in the JAX package."""
        device = batch[0].device
        actor_params = list(nets.actor.parameters())
        critic_params = list(nets.critic.parameters())
        c_l = a_l = None
        for i in range(cfg.update_steps):
            if buffer is None:
                mb = batch
            else:
                mb = _replay_sample(buffer, cfg.minibatch, generator, None if draws is None else draws['sample_idx'][i])
            tn = None
            if cfg.target_noise > 0.0:
                tn = draw(draws, 'target_noise', i, (mb[0].shape[0], cfg.action_dim), 'normal', generator, device)
            critic_opt.zero_grad(set_to_none=True)
            c_l = critic_loss(nets, cfg, mb, tn)
            c_l.backward(inputs=critic_params)
            critic_opt.step()
            if i % cfg.policy_delay == 0:
                actor_opt.zero_grad(set_to_none=True)
                a_l = actor_loss(nets, cfg, mb[0])
                a_l.backward(inputs=actor_params)
                actor_opt.step()
                # Polyak target updates (TD3 couples them to the delayed actor step)
                _polyak(nets, cfg.tau)
            else:
                a_l = torch.zeros((), dtype=torch.float32, device=device)
        return c_l.detach(), a_l.detach()

    def train_step(runner, draws: dict | None = None):
        if cfg.replay_size > 0:
            env_state, obs, nets, actor_opt, critic_opt, buffer, generator = runner
        else:
            env_state, obs, nets, actor_opt, critic_opt, generator = runner
            buffer = None
        env_state, obs, traj = collect(env_state, obs, nets, generator, draws)
        batch, rel = relabel(traj, generator, draws)
        if buffer is not None:
            _replay_insert(buffer, batch)
        c_l, a_l = update(nets, actor_opt, critic_opt, batch, buffer, generator, draws)
        done, success = rel['done'], traj['success']
        n_done = done.to(torch.float32).sum()
        metrics = {
            'critic_loss': c_l,
            'actor_loss': a_l,
            'reward_mean': traj['reward'].mean(),
            'success_rate': success.to(torch.float32).mean(),
            # of the episodes that ended in this window, the share whose
            # final step was a success (the reference's eval notion)
            'episode_success_rate': (done & success).to(torch.float32).sum() / torch.clamp(n_done, min=1.0),
            'collision_rate': (traj['mover_col'] | traj['wall_col']).to(torch.float32).mean(),
            'relabeled_frac': rel['used'].to(torch.float32).mean(),
            'relabel_reward_mean': rel['new_reward'].mean(),
        }
        if buffer is not None:
            return (env_state, obs, nets, actor_opt, critic_opt, buffer, generator), metrics
        return (env_state, obs, nets, actor_opt, critic_opt, generator), metrics

    train_step.collect, train_step.relabel, train_step.update = collect, relabel, update
    return train_step, make_optimizers(cfg)
