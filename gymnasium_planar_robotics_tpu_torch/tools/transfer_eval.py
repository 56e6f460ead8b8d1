"""In-engine training and evaluation of the transfer protocol, in PyTorch.

Counterpart of the in-engine half of the JAX package's
``tools/transfer_eval.py``: the env kwargs shared by training and
evaluation (``PLANNING_KW``, ``PUSHING_KW``, ``HORIZON``), the policy
features, DDPG+HER on sparse pushing (``train_pushing``) and the batched
deterministic eval (``eval_in_engine``, one episode per env, each env's first
episode latched).  The in-reference half (the reference MuJoCo envs) is not
part of this package.
"""

from __future__ import annotations

import time

import torch

from gymnasium_planar_robotics_tpu_torch.models import common, her, pushing
from gymnasium_planar_robotics_tpu_torch.ops import dynamics

# one source of truth for the env physics and task kwargs
PLANNING_KW = dict(std_noise=1e-5, num_cycles=40, v_max=2.0, a_max=3.0, j_max=100.0, threshold_pos=0.1)
PUSHING_KW = dict(std_noise=1e-5, num_cycles=40, v_max=2.0, a_max=10.0, j_max=100.0, threshold_pos=0.05)
HORIZON = 50  # the reference's TimeLimit


def _obs_vec(obs):
    return torch.cat([obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1).to(torch.float32)


def _pushing_vec(obs_part, achieved, desired):
    """Pushing's policy features: the plain concat plus the relative offsets
    (object - mover, goal - object); a pure function of the observation."""
    mover_pos = obs_part[..., :2]
    return torch.cat([obs_part, achieved, desired, achieved - mover_pos, desired - achieved], -1).to(torch.float32)


def run_episodes(model, config, params, act, state, obs, generator):
    """Step ``HORIZON`` eager autoreset steps under the deterministic
    ``act(obs) -> action`` and latch each env's first episode: per env
    ``success`` (``is_success`` on its last step), ``success_any`` (on any of
    its steps), ``ret`` (its return), ``terminated`` (it ended by
    termination) and ``dfin`` (its final achieved-goal distance, from the
    pre-reset observation)."""
    b, device = state.pos.shape[0], state.pos.device
    done_l = torch.zeros((b,), dtype=torch.bool, device=device)
    succ_f, succ_a, term_f = done_l.clone(), done_l.clone(), done_l.clone()
    ret = torch.zeros((b,), dtype=torch.float32, device=device)
    dfin = torch.full((b,), float('nan'), dtype=torch.float32, device=device)
    with torch.no_grad():
        for _ in range(HORIZON):
            a = act(obs)
            state, obs, rew, term, trunc, info = model.step_autoreset(config, params, state, a, generator=generator)
            done_now = (term | trunc) & ~done_l
            succ_f = succ_f | (done_now & info['is_success'])
            succ_a = succ_a | (~done_l & info['is_success'])
            term_f = term_f | (done_now & term)
            ret = ret + torch.where(done_l, 0.0, rew.to(torch.float32))
            fin = info['final_observation']
            d = dynamics.norm(fin['achieved_goal'] - fin['desired_goal']).to(torch.float32)
            dfin = torch.where(done_now, d, dfin)
            done_l = done_l | term | trunc
    if not bool(done_l.all()):
        raise RuntimeError('an episode outlived the horizon')
    return {'success': succ_f, 'success_any': succ_a, 'ret': ret, 'terminated': term_f, 'dfin': dfin}


def eval_in_engine(model, config, params, policy_fn, episodes: int, seed: int = 100):
    """Batched deterministic eval of ``policy_fn(obs_vec) -> action`` (the
    plain 8-feature concat) over ``episodes`` envs from ``init_batch`` with a
    generator seeded ``seed`` on the params' device."""
    g = torch.Generator(device=params.dt.device).manual_seed(seed)
    state, obs, _ = model.init_batch(config, params, episodes, g)
    ep = run_episodes(model, config, params, lambda o: policy_fn(_obs_vec(o)), state, obs, g)
    return {
        'episodes': episodes,
        'success': float(ep['success'].double().mean()),
        'success_any': float(ep['success_any'].double().mean()),
        'return_mean': float(ep['ret'].double().mean()),
    }


def pushing_policy(nets: her.HERNets, scale: float):
    """The deterministic HER actor on pushing's features, fed the plain
    8-feature observation vector."""

    def policy(vec):
        with torch.no_grad():
            return her.actor_action(nets.actor, _pushing_vec(vec[..., :4], vec[..., 4:6], vec[..., 6:8]), scale)

    return policy


def train_pushing(iters: int = 12000, batch: int = 256, seed: int = 0, log=print, device=None):
    """DDPG+HER with replay on sparse pushing over the eager step (the
    reference's own recipe for these envs): full-episode windows, a 4M
    replay buffer and the action-L2 regulariser.  Returns ``(policy_fn,
    (config, params))``."""
    device = common.resolve_device(device)
    config, params = pushing.make_pushing_env(device=device, **PUSHING_KW)
    cfg = her.HERConfig(
        # the network input is _pushing_vec's 12 features (obs_dim counts the
        # non-goal part: 4 observations + 2 relative pairs)
        obs_dim=8, goal_dim=2, action_dim=2, hidden=(128, 128),
        action_scale=PUSHING_KW['a_max'], rollout_steps=HORIZON, relabel_prob=0.8,
        explore_std=0.2, explore_eps=0.3, update_steps=20, gamma=0.95,
        actor_lr=3e-4, replay_size=4_000_000, minibatch=4096, action_l2=1.0,
    )
    g = torch.Generator(device=device).manual_seed(seed)
    nets = her.init_params(cfg, g, device=device)
    train_step, make_opts = her.make_train_step(
        config, params, cfg, pushing.step_autoreset,
        lambda ach, des, mc, wc: pushing.compute_reward(params, ach, des, wc),
        lambda r: r == -50.0,
        vec_fn=_pushing_vec,
    )
    state, obs, _ = pushing.init_batch(config, params, batch, g)
    runner = (state, obs, nets, *make_opts(nets), her.init_replay(cfg, device), g)
    t0 = time.time()
    for i in range(iters):
        runner, m = train_step(runner)
        if log and (i % 100 == 0 or i == iters - 1):
            log(f'  her iter {i:5d}  ep-success {float(m["episode_success_rate"]):.3f}  ({time.time() - t0:.0f}s)')
    return pushing_policy(runner[2], cfg.action_scale), (config, params)

