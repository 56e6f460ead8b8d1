"""Shared cases of the sharding tests: the configurations, the planted
episode states, the flattening of a step's outputs, and the rank worker's
scenarios (``run_rank``).

Imports numpy, torch and the port only: ``tests/torch_sharding_worker.py``
runs ``run_rank`` in processes without JAX, and the GPU test file uses the
cases on a machine without JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import ppo
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.parallel import rollout as prollout
from gymnasium_planar_robotics_tpu_torch.parallel import sharding
from torch_planning_multi_cases import make_env as multi_env
from torch_planning_multi_cases import planted_state as multi_planted

B = 256  # the global batch (2 ranks x 128, 4 x 64: multiples of the lane width, as the JAX mesh tests use)
CAND_K = 2
PLAN_KW = dict(std_noise=[2e-3, 5e-2, 1e-5], num_cycles=4)
PUSH_KW = dict(std_noise=[2e-4, 5e-3, 1e-5], num_cycles=4)
#: the fused step's families: name -> (model module, movers)
STEP_CASES = {'planning_m1': (tplan, 1), 'pushing': (tpush, 1), 'planning_m4': (tplan, 4)}
T_ROLL, K_LONG = 3, 32  # the K=1 rollout's steps; the K-step rollout's K (one chunk)
PPO_T, PPO_ITERS = 2, 2
EAGER_B = 16  # tests/test_sharding.py:34-55's scenario: 2 movers, 10 cycles, float64
DIST_CALLS = ('all_reduce', 'all_gather', 'all_gather_into_tensor', 'broadcast', 'reduce', 'reduce_scatter',
              'reduce_scatter_tensor', 'all_to_all', 'all_to_all_single', 'gather', 'scatter', 'barrier', 'send',
              'recv', 'isend', 'irecv', 'all_gather_object', 'broadcast_object_list')


def make_env(name: str, device='cpu', **kw):
    """The port's (config, params) of a step case."""
    if name == 'planning_m1':
        return tplan.make_planning_env(np.ones((3, 3)), 1, device=device, **PLAN_KW, **kw)
    if name == 'pushing':
        return tpush.make_pushing_env(device=device, **PUSH_KW, **kw)
    if name == 'planning_m4':
        return multi_env('circle_full_acc_m4', device=device, **PLAN_KW, **kw)
    raise KeyError(name)


def episode_state(name: str, cfg, prm, b: int, seed: int = 0):
    """A state with wall hits, truncation restarts and running episodes:
    planning 1 mover, a quarter of the envs at the +x edge moving out;
    pushing, half the movers planted at the object, a quarter at the -x wall
    moving out; 4 movers, ``torch_planning_multi_cases.planted_state``;
    every 8th env about to truncate."""
    if name == 'planning_m4':
        return multi_planted('circle_full_acc_m4', cfg, prm, b, seed)
    model = STEP_CASES[name][0]
    g = torch.Generator().manual_seed(seed)
    state, _, _ = model.init_batch(cfg, prm, b, g)
    pos, vel = state.pos.clone(), state.vel.clone()
    q = b // 4
    if name == 'planning_m1':
        pos[:q, 0, 0] = torch.linspace(0.58, 0.64, q, device=pos.device)
        vel[:q, 0] = torch.tensor([1.0, 0.1], device=pos.device)
    else:
        h = b // 2
        pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0], device=pos.device)
        vel[:h] = torch.tensor([0.4, 0.0], device=pos.device)
        pos[h:h + q, 0] = 0.115
        vel[h:h + q] = torch.tensor([-1.0, 0.2], device=pos.device)
    steps = torch.randint(0, 45, (b,), generator=g, dtype=torch.int32)
    steps[::8] = cfg.max_episode_steps - 1
    steps = steps.to(state.steps.device)
    return dataclasses.replace(state, pos=pos, vel=vel, steps=steps)


def step_inputs(name: str, b: int = B, seed: int = 0) -> dict:
    """The fused step's inputs of a case as numpy: state fields, actions
    ``[B, 2M]`` and injected uniforms ``[noise_planes, B]``."""
    model, m = STEP_CASES[name]
    cfg, prm = make_env(name)
    state = episode_state(name, cfg, prm, b, seed)
    rng = np.random.default_rng(seed + 1)
    n = model.make_fused_step_autoreset(cfg, prm, cand_k=CAND_K).noise_planes
    return {**{f'state.{k}': v for k, v in model.state_to_numpy(state).items()},
            'action': rng.uniform(-8.0, 8.0, (b, 2 * m)).astype(np.float32),
            'noise': rng.random((n, b), dtype=np.float32)}


def state_from(name: str, arrays: dict, prefix: str = 'state.'):
    model = STEP_CASES[name][0]
    return model.state_from_numpy({k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)},
                                  device='cpu')


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def flat_step(out) -> dict:
    """A step's ``(state, obs, reward, terminated, truncated, info)`` as a
    flat dict of numpy arrays (``state.pos``, ``obs.achieved_goal``,
    ``info.final_observation.observation``, ...)."""
    state, obs, reward, term, trunc, info = out
    flat = {f'state.{f.name}': _np(getattr(state, f.name)) for f in dataclasses.fields(state)}
    flat.update({f'obs.{k}': _np(v) for k, v in obs.items()})
    flat.update(reward=_np(reward), terminated=_np(term), truncated=_np(trunc))
    for k, v in info.items():
        if isinstance(v, dict):
            flat.update({f'info.{k}.{kk}': _np(vv) for kk, vv in v.items()})
        else:
            flat[f'info.{k}'] = _np(v)
    return flat


def flat_rollout(out) -> dict:
    """A fused rollout's ``(final state, rewards, terminated, truncated)``."""
    state, rew, term, trunc = out
    flat = {f'state.{f.name}': _np(getattr(state, f.name)) for f in dataclasses.fields(state)}
    flat.update(reward=_np(rew), terminated=_np(term), truncated=_np(trunc))
    return flat


def flat_reactive(out) -> dict:
    """A reactive rollout's ``(final state, traj, last_obs_vec)``."""
    state, (obs_vec, (raw, logp, value), reward, term, trunc, final_vec), last = out
    flat = {f'state.{f.name}': _np(getattr(state, f.name)) for f in dataclasses.fields(state)}
    flat.update(obs_vec=_np(obs_vec), raw=_np(raw), logp=_np(logp), value=_np(value), reward=_np(reward),
                terminated=_np(term), truncated=_np(trunc), final_vec=_np(final_vec), last=_np(last))
    return flat


def duplicated(name: str, half: int, seed: int):
    """A global batch of two copies of one ``half``-env state: the ranks
    hold equal shards, so what differs between them is their streams."""
    cfg, prm = make_env(name)
    s = episode_state(name, cfg, prm, half, seed)
    return dataclasses.replace(s, **{f.name: torch.cat([getattr(s, f.name)] * 2) for f in dataclasses.fields(s)})


def rollout_actions(b: int, t: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(-5.0, 5.0, (t, b, 2)).astype(np.float32))


def ppo_config():
    return ppo.PPOConfig(obs_dim=6, action_dim=2, hidden=(16, 16), rollout_steps=PPO_T, learning_rate=1e-3,
                         action_scale=3.0)


def ppo_env():
    """1-mover planning with dense shaping, the sharded PPO example's, cut to 4 cycles."""
    return tplan.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0, reward_mode='dense',
                                   num_cycles=4, device='cpu')


def policy_step_of(cfg):
    def policy_step(pol, gen, obs_pm):
        action, raw, logp, value = ppo.sample_action_pm(pol, obs_pm, gen, cfg.action_scale)
        return action, (raw, logp, value)

    return policy_step


def run_ppo(mesh, state, obs_vec, reactive: bool, noises=None) -> tuple:
    """Two PPO iterations from ``state`` and ``obs_vec`` (this rank's shard,
    or the global batch without a mesh) with the policy and generators
    seeded alike; the
    fused step takes ``noises[i]`` ``[noise_planes, B]`` (global) at its
    i-th call.  Returns (the policy's parameters flat, the metrics)."""
    cfg = ppo_config()
    config, params = ppo_env()
    policy = ppo.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')
    g = torch.Generator().manual_seed(2)
    if reactive:
        kconfig, kparams = tplan.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0, num_cycles=4,
                                                   device='cpu')

        def make(ps):
            if mesh is None:
                return tplan.make_reactive_rollout(kconfig, kparams, ps, cfg.rollout_steps, dense_reward=True)
            return sharding.make_sharded_reactive_rollout(tplan, kconfig, kparams, ps, cfg.rollout_steps, mesh,
                                                          dense_reward=True)

        step, make_opt = ppo.make_train_step_reactive(cfg, make, mesh=mesh)
        runner = (state, policy, make_opt(policy), g, 0)
    else:
        calls = iter(range(len(noises)))
        if mesh is None:
            fused = tplan.make_fused_step_autoreset(config, params)
        else:
            fused = sharding.make_sharded_fused_step(tplan, config, params, mesh)

        def batched(s, a):
            return fused(s, a, noise=noises[next(calls)])

        step, make_opt = ppo.make_train_step(config, params, cfg, batched_step_fn=batched, mesh=mesh)
        runner = (state, obs_vec, policy, make_opt(policy), g)
    metrics = []
    for _ in range(PPO_ITERS):
        runner, m = step(runner)
        metrics.append(torch.stack([m['loss'], m['reward_mean'], m['done_rate']]))
    flat = torch.cat([p.detach().reshape(-1) for p in policy.parameters()])
    return _np(flat), _np(torch.stack(metrics))


def ppo_noises(seed: int = 9) -> list:
    cfg, prm = ppo_env()
    n = tplan.make_fused_step_autoreset(cfg, prm).noise_planes
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((n, B), dtype=np.float32)) for _ in range(PPO_T * PPO_ITERS)]


def ppo_state():
    """The PPO runs' global batch: (state, observation vector)."""
    cfg, prm = ppo_env()
    state, obs, _ = tplan.init_batch(cfg, prm, B, torch.Generator().manual_seed(1))
    return state, torch.cat([obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1).to(torch.float32)


def zero_uniforms(n, batch, device, generator=None):
    """Stand-in for ``kernels.draw_uniforms``: all-zero uniforms, so the
    kernels' draws do not depend on the rank's seed."""
    return torch.zeros((n, batch), dtype=torch.float32, device=device)


def count_dist_calls(fn):
    """(result of ``fn()``, the ``torch.distributed`` calls it made by name)."""
    import torch.distributed as dist

    counts, saved = {}, {}
    for name in DIST_CALLS:
        if hasattr(dist, name):
            saved[name] = getattr(dist, name)

            def wrap(*a, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return saved[_name](*a, **kw)

            setattr(dist, name, wrap)
    try:
        return fn(), counts
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)


def run_rank(mesh, inputs: dict, world: int) -> dict:
    """Every sharded scenario on this rank; numpy outputs by name."""
    out = {}
    r = mesh.get_local_rank()
    for name, (model, _) in STEP_CASES.items():
        if world == 4 and name != 'planning_m1':
            continue
        cfg, prm = make_env(name)
        arrays = {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + '/')}
        state = sharding.shard_batch(state_from(name, arrays), mesh)
        step = sharding.make_sharded_fused_step(model, cfg, prm, mesh, cand_k=CAND_K)
        res, calls = count_dist_calls(lambda: step(state, torch.from_numpy(arrays['action']),
                                                   noise=torch.from_numpy(arrays['noise'])))
        out.update({f'{name}/{k}': v for k, v in flat_step(res).items()})
        out[f'{name}/dist_calls'] = np.asarray(sum(calls.values()))
        if name == 'planning_m1':
            _, _, rew, term, _, info = res
            summary, calls = count_dist_calls(lambda: sharding.metrics_summary(rew, term, info, mesh))
            out.update({f'summary/{k}': _np(v) for k, v in summary.items()})
            out['summary/dist_calls'] = np.asarray(sum(calls.values()))
            out['summary/all_reduce_calls'] = np.asarray(calls.get('all_reduce', 0))
    if world == 4:
        return out

    # the eager step under sharded_step_fn (float64, std_noise 0)
    ecfg, eprm = tplan.make_planning_env(np.ones((3, 3)), 2, std_noise=0.0, num_cycles=10, dtype=torch.float64,
                                         device='cpu')
    estate = tplan.state_from_numpy({k[len('eager/state.'):]: v for k, v in inputs.items()
                                     if k.startswith('eager/state.')}, device='cpu')
    estep = sharding.sharded_step_fn(ecfg, eprm, mesh, tplan.step)
    res = estep(sharding.shard_batch(estate, mesh), torch.from_numpy(inputs['eager/action']),
                generator=torch.Generator().manual_seed(3))
    out.update({f'eager/{k}': v for k, v in flat_step(res).items()})

    # the rollouts on duplicated shards: K=1 and K-step, pushing and planning
    for name in ('pushing', 'planning_m1'):
        model = STEP_CASES[name][0]
        cfg, prm = make_env(name)
        state = sharding.shard_batch(duplicated(name, B // 2, 7), mesh)
        for k, t in ((1, T_ROLL), (K_LONG, K_LONG)):
            roll = sharding.make_sharded_fused_rollout(model, cfg, prm, mesh, steps_per_launch=k)
            res = roll(state, rollout_actions(B, t, 8), 11)
            out.update({f'roll_{name}_K{k}/{kk}': v for kk, v in flat_rollout(res).items()})
    pcfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(16, 16), rollout_steps=2, action_scale=10.0)
    pol = ppo.init_params(pcfg, torch.Generator().manual_seed(0), device='cpu')
    cfg, prm = make_env('pushing')
    react = sharding.make_sharded_reactive_rollout(tpush, cfg, prm, policy_step_of(pcfg), 2, mesh)
    state = sharding.shard_batch(duplicated('pushing', B // 2, 12), mesh)
    out.update({f'reactive/{k}': v for k, v in
                flat_reactive(react(state, pol, torch.Generator().manual_seed(5), 13)).items()})

    # the rollout loop over the sharded fused step: global metrics
    cfg, prm = make_env('planning_m1')
    state = sharding.shard_batch(duplicated('planning_m1', B // 2, 14), mesh)
    loop = prollout.fused_rollout_loop(tplan, cfg, prm, prollout.uniform_policy(2, -5.0, 5.0), 3, mesh=mesh,
                                       cand_k=CAND_K)
    obs = {'observation': state.vel[:, 0]}
    _, _, _, metrics = loop(state, obs, torch.Generator().manual_seed(15))
    out.update({f'loop/{k}': _np(v) for k, v in metrics.items()})

    # sharded PPO: the fused step on injected draws, and the reactive
    # rollout on all-zero kernel draws
    state, obs_vec = sharding.shard_batch(ppo_state(), mesh)
    out['ppo_fused/params'], out['ppo_fused/metrics'] = run_ppo(mesh, state, obs_vec, False, ppo_noises())
    saved = kernels.draw_uniforms
    kernels.draw_uniforms = zero_uniforms
    try:
        out['ppo_reactive/params'], out['ppo_reactive/metrics'] = run_ppo(mesh, state, obs_vec, True)
    finally:
        kernels.draw_uniforms = saved
    out['rank'] = np.asarray(r)
    return out
