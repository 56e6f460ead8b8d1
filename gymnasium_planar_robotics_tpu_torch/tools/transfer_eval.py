"""In-engine training and evaluation of the transfer protocol, in PyTorch.

Counterpart of the in-engine half of the JAX package's
``tools/transfer_eval.py``: the env kwargs shared by training and
evaluation (``PLANNING_KW``, ``PUSHING_KW``, ``HORIZON``), the policy
features, the trainers over the eager ``step_autoreset`` (PPO with dense
shaping on 1-mover planning, ``train_planning``, and on pushing,
``train_pushing_ppo``; DDPG+HER on sparse pushing, ``train_pushing``), the
scripted pursuit policy (``scripted_pursuit_policy``), the batched
deterministic eval (``eval_in_engine``, one episode per env, each env's first
episode latched), ``run_family`` and the command line, on the card unless
``--device`` names another::

    python -m gymnasium_planar_robotics_tpu_torch.tools.transfer_eval \
        [--families planning pushing-ppo pushing pushing-scripted] [--episodes 200] [--train-iters N] [--seed 0]

It prints one JSON line per family, ``{'family', 'engine'}``.  The
in-reference half (``eval_in_reference``, the ``reference`` and
``success_gap`` keys, ``--write-md``) evaluates in the reference MuJoCo
envs, which are not part of this repository, and is not ported.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, her, planning, ppo, pushing
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


def planning_policy(policy: ppo.ActorCritic, a_max: float):
    """The deterministic PPO policy of planning: the mean action clipped to
    +-``a_max``, fed the plain observation vector."""
    from gymnasium_planar_robotics_tpu_torch.tools.train_push_strong import det_policy

    act = det_policy(a_max)
    return lambda vec: act(policy, vec)


def pushing_ppo_policy(policy: ppo.ActorCritic, a_max: float):
    """The deterministic PPO policy of pushing: the mean action on pushing's
    features clipped to +-``a_max``, fed the plain 8-feature vector."""
    act = planning_policy(policy, a_max)
    return lambda vec: act(_pushing_vec(vec[..., :4], vec[..., 4:6], vec[..., 6:8]))


def _train_ppo(config, params, cfg: ppo.PPOConfig, model, obs_to_vec, iters: int, batch: int, seed: int, log,
               every: int, label: str, timings: dict | None):
    """PPO over the eager ``model.step_autoreset`` for ``iters``
    iterations on ``batch`` envs; the trained policy.  ``timings``, when
    given, receives ``iter_ms`` (each iteration, ending in a
    synchronisation on the card)."""
    device = params.dt.device
    g = torch.Generator(device=device).manual_seed(seed)
    pol = ppo.init_params(cfg, g, device=device)
    train_step, make_opt = ppo.make_train_step(config, params, cfg, model.step_autoreset, obs_to_vec=obs_to_vec)
    state, obs, _ = model.init_batch(config, params, batch, g)
    runner = (state, (obs_to_vec or _obs_vec)(obs), pol, make_opt(pol), g)
    if timings is not None:
        timings['iter_ms'] = []
    t0 = time.time()
    for i in range(iters):
        t_it = time.perf_counter()
        runner, m = train_step(runner)
        if timings is not None:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            timings['iter_ms'].append((time.perf_counter() - t_it) * 1e3)
        if log and (i % every == 0 or i == iters - 1):
            log(f'  ppo iter {i:5d}  {label} {float(m["reward_mean"]):8.3f}  ({time.time() - t0:.0f}s)')
    return runner[2]


def train_planning(iters: int = 300, batch: int = 1024, seed: int = 0, log=print, device=None,
                   timings: dict | None = None):
    """PPO with dense shaping on 1-mover planning over the eager step
    ((64, 64), rollout 16, lr 1e-3, 4 epochs).  Returns ``(policy_fn,
    (config, params))``: the deterministic mean action clipped to +-``a_max``
    and the sparse config it is evaluated on (the dense reward is a
    training aid only)."""
    device = common.resolve_device(device)
    config, params = planning.make_planning_env(np.ones((3, 3)), 1, reward_mode='dense', device=device,
                                                **PLANNING_KW)
    cfg = ppo.PPOConfig(
        obs_dim=6, action_dim=2, hidden=(64, 64), rollout_steps=16,
        action_scale=PLANNING_KW['a_max'], learning_rate=1e-3, update_epochs=4,
    )
    pol = _train_ppo(config, params, cfg, planning, None, iters, batch, seed, log, 50, 'reward', timings)
    eval_config, eval_params = planning.make_planning_env(np.ones((3, 3)), 1, reward_mode='sparse', device=device,
                                                          **PLANNING_KW)
    return planning_policy(pol, PLANNING_KW['a_max']), (eval_config, eval_params)


def train_pushing_ppo(iters: int = 30000, batch: int = 2048, seed: int = 0, log=print, device=None,
                      timings: dict | None = None):
    """PPO with dense shaping on pushing over the eager step: the strong
    recipe ``entropy_big`` of ``tools/train_push_strong.py`` ((256, 256),
    rollout 25, lr 3e-4, entropy 3e-3, pushing's 12 features).  Returns
    ``(policy_fn, (config, params))``, the policy clipped to +-``a_max`` and
    fed the plain 8-feature vector, the config the sparse one."""
    from gymnasium_planar_robotics_tpu_torch.tools.train_push_strong import RECIPES, obs_to_vec

    recipe = RECIPES['entropy_big']
    device = common.resolve_device(device)
    config, params = pushing.make_pushing_env(reward_mode='dense', device=device, **PUSHING_KW)
    cfg = ppo.PPOConfig(
        obs_dim=12, action_dim=2, hidden=recipe['hidden'], rollout_steps=25,
        action_scale=PUSHING_KW['a_max'], learning_rate=3e-4, update_epochs=4,
        entropy_coef=recipe['entropy_coef'],
    )
    pol = _train_ppo(config, params, cfg, pushing, obs_to_vec, iters, batch, seed, log, 500, 'shaped reward',
                     timings)
    eval_config, eval_params = pushing.make_pushing_env(device=device, **PUSHING_KW)
    return pushing_ppo_policy(pol, PUSHING_KW['a_max']), (eval_config, eval_params)


def scripted_pursuit_policy(device=None):
    """The deterministic scripted pushing policy (no training): accelerate
    toward the stand-off point behind the object, brake near contact, the
    acceleration's norm capped at ``a_max``.  Returns ``(policy_fn, (config,
    params))``."""
    a_max = PUSHING_KW['a_max']

    def policy(vec):
        mover, mover_vel = vec[..., :2], vec[..., 2:4]
        obj, goal = vec[..., 4:6], vec[..., 6:8]
        to_goal = goal - obj
        d = torch.linalg.vector_norm(to_goal, dim=-1, keepdim=True)
        push_dir = to_goal / torch.clamp(d, min=1e-6)
        target = obj - 0.11 * push_dir
        acc = 60.0 * (target - mover) - 12.0 * mover_vel
        n = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
        return torch.where(n <= a_max, acc, a_max * acc / torch.clamp(n, min=1e-9))

    config, params = pushing.make_pushing_env(device=common.resolve_device(device), **PUSHING_KW)
    return policy, (config, params)


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


FAMILIES = ('planning', 'pushing-ppo', 'pushing', 'pushing-scripted')


def run_family(family: str, episodes: int, train_iters: int | None, seed: int, log=print, device=None):
    """Train (or script) a family's policy and evaluate it in-engine over
    ``max(episodes, 512)`` episodes.  Returns ``{'family', 'engine'}``."""
    kw = dict(seed=seed, log=log, device=device)
    if family == 'pushing-scripted':
        log(f'[{family}] scripted pursuit policy (no training)')
        policy, (config, params) = scripted_pursuit_policy(device)
        model = pushing
    elif family == 'planning':
        log(f'[{family}] training in-engine ...')
        policy, (config, params) = train_planning(iters=train_iters or 300, **kw)
        model = planning
    elif family == 'pushing-ppo':
        log(f'[{family}] training in-engine (PPO, dense shaping) ...')
        policy, (config, params) = train_pushing_ppo(iters=train_iters or 30000, **kw)
        model = pushing
    elif family == 'pushing':
        log(f'[{family}] training in-engine ...')
        policy, (config, params) = train_pushing(iters=train_iters or 12000, **kw)
        model = pushing
    else:
        raise ValueError(f'unknown family {family!r}: one of {FAMILIES}')
    n = max(episodes, 512)
    log(f'[{family}] evaluating in-engine ({n} episodes) ...')
    result = {'family': family, 'engine': eval_in_engine(model, config, params, policy, n, seed=seed + 100)}
    log(json.dumps(result))
    return result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description='In-engine training and evaluation of the transfer protocol.')
    ap.add_argument('--families', nargs='+', default=list(FAMILIES), choices=FAMILIES)
    ap.add_argument('--episodes', type=int, default=200,
                    help='the reference episodes of the JAX tool; the in-engine eval runs max(episodes, 512)')
    ap.add_argument('--train-iters', type=int, default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args(argv)
    return [run_family(f, args.episodes, args.train_iters, args.seed, device=args.device) for f in args.families]


if __name__ == '__main__':
    main()
