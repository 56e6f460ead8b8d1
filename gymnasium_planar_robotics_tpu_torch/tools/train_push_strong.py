"""The strong-pushing PPO recipe on the eager step, with strict evals.

Counterpart of the JAX package's ``tools/train_push_strong.py``: PPO with
the dense shaping on the eager ``pushing.step_autoreset``, evaluated
strictly (the sparse reference scoring: ``is_success`` on an episode's last
step) with failure-mode diagnostics.  On the card by default::

    python -m gymnasium_planar_robotics_tpu_torch.tools.train_push_strong \\
        --iters 12000 --batch 2048 [--recipe baseline] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import common, ppo, pushing
from gymnasium_planar_robotics_tpu_torch.tools.transfer_eval import HORIZON, PUSHING_KW, _pushing_vec, run_episodes


def obs_to_vec(obs):
    """The recipe's 12 features: mover position and velocity, achieved,
    goal, achieved - mover, goal - achieved."""
    return _pushing_vec(obs['observation'], obs['achieved_goal'], obs['desired_goal'])


def make_eval(eval_config, eval_params, episodes: int = 1024, seed: int = 100):
    """Strict eval and diagnostics over one episode per env: final-step
    success, any-step success, wall rate, and the final object-goal distance
    (median, p90).  ``run(policy, policy_fn, initial=None)``: ``initial`` is
    ``(state, obs, generator)`` to start from given episodes, else
    ``init_batch`` of ``episodes`` envs from a generator seeded ``seed`` on
    the params' device.  Each env's first episode is latched, so what
    happens after it does not count."""

    def run(policy, policy_fn, initial=None):
        if initial is None:
            g = torch.Generator(device=eval_params.dt.device).manual_seed(seed)
            state, obs, _ = pushing.init_batch(eval_config, eval_params, episodes, g)
        else:
            state, obs, g = initial
        ep = run_episodes(pushing, eval_config, eval_params, lambda o: policy_fn(policy, obs_to_vec(o)), state, obs,
                          g)
        dfin = ep['dfin'].cpu().numpy()
        # pushing terminates only on a wall hit
        return dict(success=float(ep['success'].double().mean()), success_any=float(ep['success_any'].double().mean()),
                    wall_rate=float(ep['terminated'].double().mean()), dfin_med=float(np.nanmedian(dfin)),
                    dfin_p90=float(np.nanquantile(dfin, 0.9)))

    return run


def det_policy(a_max: float):
    """The deterministic policy of the evals: the mean action, clipped."""

    def policy_fn(policy, vec):
        with torch.no_grad():
            return torch.clamp(ppo.apply(policy, vec)[0], -a_max, a_max)

    return policy_fn


def train(recipe: str, iters: int, batch: int, seed: int, eval_every: int, log=print, device=None,
          timings: dict | None = None):
    """Train the recipe for ``iters`` iterations on ``batch`` envs, with a
    strict eval every ``eval_every`` iterations and after the last; returns
    the policy.  ``timings``, when given, receives ``iter_ms`` (each
    iteration, ending in a synchronisation on the card), ``evals`` (each
    eval's metrics), ``eval_s`` (each eval's seconds), and the
    ``train_step`` and last ``runner`` (``(state, obs_vec, policy,
    optimizer, generator)``), to time the train step's parts on."""
    device = common.resolve_device(device)
    r = RECIPES[recipe]
    config, params = pushing.make_pushing_env(reward_mode='dense', device=device, **PUSHING_KW)
    if r.get('env_tweak'):
        config, params = r['env_tweak'](config, params)
    cfg = ppo.PPOConfig(
        obs_dim=12, action_dim=2, hidden=r.get('hidden', (128, 128)), rollout_steps=r.get('rollout_steps', 25),
        action_scale=PUSHING_KW['a_max'], learning_rate=r.get('lr', 3e-4), update_epochs=r.get('update_epochs', 4),
        gamma=r.get('gamma', 0.99), entropy_coef=r.get('entropy_coef', 0.0),
    )
    g = torch.Generator(device=device).manual_seed(seed)
    pol = ppo.init_params(cfg, g, device=device)
    train_step, make_opt = ppo.make_train_step(config, params, cfg, pushing.step_autoreset, obs_to_vec=obs_to_vec)
    state, obs, _ = pushing.init_batch(config, params, batch, g)
    runner = (state, obs_to_vec(obs), pol, make_opt(pol), g)

    eval_config, eval_params = pushing.make_pushing_env(device=device, **PUSHING_KW)
    evaluate = make_eval(eval_config, eval_params)
    policy_fn = det_policy(PUSHING_KW['a_max'])
    if timings is not None:
        timings.update(iter_ms=[], evals=[], eval_s=[])

    t0 = time.time()
    best = None
    for i in range(iters):
        t_it = time.perf_counter()
        runner, m = train_step(runner)
        if timings is not None:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            timings['iter_ms'].append((time.perf_counter() - t_it) * 1e3)
        if (i + 1) % eval_every == 0 or i == iters - 1:
            t_ev = time.perf_counter()
            ev = evaluate(runner[2], policy_fn)
            if timings is not None:
                timings['evals'].append(ev)
                timings['eval_s'].append(time.perf_counter() - t_ev)
            log(f'iter {i + 1:6d}  t={time.time() - t0:5.0f}s  shaped_r {float(m["reward_mean"]):7.3f}  '
                f'succ {ev["success"]:.3f}  any {ev["success_any"]:.3f}  wall {ev["wall_rate"]:.3f}  '
                f'dfin_med {ev["dfin_med"]:.3f}  p90 {ev["dfin_p90"]:.3f}')
            if best is None or ev['success'] > best[1]:
                best = (i + 1, ev['success'])
    log(f'best: iter {best[0]} success {best[1]:.3f}')
    if timings is not None:
        timings.update(train_step=train_step, runner=runner)
    return runner[2]


RECIPES = {
    'baseline': {},
    'long': dict(rollout_steps=50, gamma=0.995),
    'entropy': dict(entropy_coef=3e-3),
    'entropy_big': dict(entropy_coef=3e-3, hidden=(256, 256)),
    'big': dict(hidden=(256, 256)),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--recipe', default='baseline', choices=sorted(RECIPES))
    ap.add_argument('--iters', type=int, default=12000)
    ap.add_argument('--batch', type=int, default=2048)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--eval-every', type=int, default=2000)
    ap.add_argument('--device', default=None, help='the card unless named (e.g. cpu)')
    args = ap.parse_args()
    print(json.dumps(vars(args)))
    train(args.recipe, args.iters, args.batch, args.seed, args.eval_every, device=args.device)


if __name__ == '__main__':
    main()
