"""Port parity: ``models/her.py`` (networks, relabelling, n-step backups, the
replay buffer, the train step), ``tools/train_push_her.py`` and the
in-engine half of ``tools/transfer_eval.py`` against the JAX package's.

The JAX side runs with x64 off (``jax.enable_x64(False)``), as the JAX
package runs on its accelerator: its HER step draws its exploration noise
without a dtype, so under the suite's x64 it would act in float64 where
the port acts in float32.  Weights cross over through the JAX layout
(``params_from_numpy``); every draw of the JAX train step is recomputed from
its key (the step's own splits) and handed to the port (``draws=``).
Tolerances, each with its reason: relabelling, episode ends, replay rows and
indices exact (the same integer and select arithmetic); n-step pieces rtol
1e-6 (one float32 product a term); forward passes rtol 1e-5 / atol 1e-6
(float32 products summed in another order); the train step's in its test.

Run as a script, the file runs the JAX package's HER learning gate
(``tests/test_her_learning.py``) at other seeds: ``python
tests/test_torch_her.py 0 1 2 3``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax  # noqa: F401  (the JAX learner's optimizer)
import torch

from gymnasium_planar_robotics_tpu.models import her as jher
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.models import her as ther
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.tools import train_push_her, transfer_eval

FWD = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _f32_jax():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with jax.enable_x64(False):
        yield
    torch.set_num_threads(prev)


def tcfg_of(cfg):
    return ther.HERConfig(**dataclasses.asdict(cfg))


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_episode_ends_relabel_and_nstep_match_jax():
    rng = np.random.default_rng(0)
    T, B = 12, 40
    done = rng.random((T, B)) < 0.25
    ends = ther.episode_end_indices(torch.from_numpy(done))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(jher.episode_end_indices(jnp.asarray(done))))

    next_achieved = rng.normal(size=(T, B, 2)).astype(np.float32)
    desired = rng.normal(size=(T, B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jnew, jused = jher.relabel_future(key, jnp.asarray(done), jnp.asarray(next_achieved), jnp.asarray(desired), 0.7)
    k_u, k_p = jax.random.split(key)
    u, p = (torch.from_numpy(np.asarray(jax.random.uniform(k, (T, B)))) for k in (k_u, k_p))
    tnew, tused = ther.relabel_future(torch.from_numpy(done), torch.from_numpy(next_achieved),
                                      torch.from_numpy(desired), 0.7, draws=(u, p))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(tused.numpy(), np.asarray(jused))
    assert 0.5 < float(tused.double().mean()) < 0.9
    # a generator draws for itself, inside each episode
    gnew, gused = ther.relabel_future(torch.from_numpy(done), torch.from_numpy(next_achieved),
                                      torch.from_numpy(desired), 1.0, generator=torch.Generator().manual_seed(1))
    assert bool(gused.all())

    n, gamma = 3, 0.9
    rew = rng.normal(size=(T, B)).astype(np.float32)
    term = rng.random((T, B)) < 0.1
    snext = rng.normal(size=(T, B, 3)).astype(np.float32)

    def pad(x, k):
        return np.concatenate([x[k:], np.zeros((k,) + x.shape[1:], x.dtype)])

    jout = jher.nstep_backup(n, gamma, jnp.asarray(done), lambda k: jnp.asarray(pad(rew, k)),
                             lambda k: jnp.asarray(pad(term, k)), lambda k: jnp.asarray(pad(snext, k)))
    tout = ther.nstep_backup(n, gamma, torch.from_numpy(done), lambda k: torch.from_numpy(pad(rew, k)),
                             lambda k: torch.from_numpy(pad(term, k)), lambda k: torch.from_numpy(pad(snext, k)))
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize('twin', [False, True])
def test_networks_match_jax(twin):
    """Init layout, the converters (exact both ways), ``actor_action`` and
    ``critic_q`` (the first head of a twin critic) on the same weights."""
    cfg = jher.HERConfig(obs_dim=8, goal_dim=2, action_dim=2, hidden=(32, 24), action_scale=10.0, twin_critic=twin)
    jpar = jher.init_params(jax.random.PRNGKey(0), cfg)
    nets = ther.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpar), device='cpu')
    for got, want in zip(leaves(ther.params_to_numpy(nets)), leaves(jpar)):
        np.testing.assert_array_equal(got, want)
    obs = np.random.default_rng(1).normal(size=(64, 12)).astype(np.float32)
    act = np.random.default_rng(2).normal(size=(64, 2)).astype(np.float32)
    with torch.no_grad():
        ta = ther.actor_action(nets.actor, torch.from_numpy(obs), 10.0)
        tq = ther.critic_q(nets.critic, torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(ta.numpy(), np.asarray(jher.actor_action(jpar['actor'], jnp.asarray(obs), 10.0)), **FWD)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jher.critic_q(jpar['critic'], jnp.asarray(obs),
                                                                     jnp.asarray(act))), **FWD)
    # the port's own init: the JAX package's shapes and distributions, targets equal
    tnets = ther.init_params(tcfg_of(dataclasses.replace(cfg, hidden=(256, 256))), torch.Generator().manual_seed(0),
                             device='cpu')
    tree = ther.params_to_numpy(tnets)
    jtree = jher.init_params(jax.random.PRNGKey(1), dataclasses.replace(cfg, hidden=(256, 256)))
    assert [x.shape for x in leaves(tree)] == [x.shape for x in leaves(jtree)]
    for got, want in zip(leaves(tree['actor_target']) + leaves(tree['critic_target']),
                         leaves(tree['actor']) + leaves(tree['critic'])):
        np.testing.assert_array_equal(got, want)
    heads = tree['critic'] if twin else [tree['critic']]
    for w, std in ((tree['actor'][0]['w'], (2 / 12) ** 0.5), (tree['actor'][1]['w'], (2 / 256) ** 0.5),
                   (tree['actor'][2]['w'], 0.01), (heads[0][2]['w'], 1.0)):
        assert abs(w.std() / std - 1) < (0.1 if w.size > 1000 else 0.6) and abs(w.mean()) < std / 3
    assert not any(layer['b'].any() for layer in tree['actor'])
    assert not twin or not np.array_equal(heads[0][0]['w'], heads[1][0]['w'])


def test_replay_insert_and_sample_match_jax():
    """Two inserts that wrap around, then a sample at the indices the JAX
    step draws: rows, ``ptr`` and ``filled`` equal."""
    cfg = jher.HERConfig(obs_dim=2, goal_dim=2, action_dim=2, replay_size=100, minibatch=32)
    rng = np.random.default_rng(4)

    def batch(m):
        return tuple(rng.normal(size=s).astype(np.float32) for s in ((m, 6), (m, 2), (m,), (m, 6), (m,), (m,)))

    jbuf, tbuf = jher.init_replay(cfg), ther.init_replay(tcfg_of(cfg), device='cpu')
    for m in (70, 60):
        b = batch(m)
        jbuf = jher._replay_insert(jbuf, tuple(jnp.asarray(x) for x in b))
        ther._replay_insert(tbuf, tuple(torch.from_numpy(x) for x in b))
        assert (tbuf['ptr'], tbuf['filled']) == (int(jbuf['ptr']), int(jbuf['filled']))
    for name in ther.REPLAY_FIELDS:
        np.testing.assert_array_equal(tbuf[name].numpy(), np.asarray(jbuf[name]), err_msg=name)
    key = jax.random.PRNGKey(5)
    jmb = jher._replay_sample(jbuf, key, cfg.minibatch)
    idx = jax.random.randint(key, (cfg.minibatch,), 0, jnp.maximum(jbuf['filled'], 1))
    tmb = ther._replay_sample(tbuf, cfg.minibatch, idx=torch.from_numpy(np.asarray(idx)).long())
    for got, want in zip(tmb, jmb):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match='do not fit'):
        ther._replay_insert(tbuf, tuple(torch.from_numpy(x) for x in batch(101)))


def jax_draws(key, cfg, b, filled):
    """Every draw of one JAX ``train_step`` from its runner key, in the
    port's ``draws`` layout (``her.py``'s splits, in its order)."""
    s, A, T = cfg.action_scale, cfg.action_dim, cfg.rollout_steps
    _, k_roll, k_rel, k_upd = jax.random.split(key, 4)
    k_c, k_a = jax.random.split(jax.random.fold_in(k_roll, 7))
    d = {'explore_coin': jax.random.uniform(k_c, (b,)),
         'explore_held': jax.random.uniform(k_a, (b, A), minval=-s, maxval=s)}
    k = k_roll
    noise, coin, rand_a = [], [], []
    for _ in range(T):
        k, k_n, k_e, k_u = jax.random.split(k, 4)
        noise.append(jax.random.normal(k_n, (b, A)))
        rand_a.append(jax.random.uniform(k_u, (b, A), minval=-s, maxval=s))
        coin.append(jax.random.uniform(k_e, (b,)))
    d.update(noise=jnp.stack(noise), coin=jnp.stack(coin), rand_a=jnp.stack(rand_a))
    k_u, k_p = jax.random.split(k_rel)
    d['relabel'] = (jax.random.uniform(k_u, (T, b)), jax.random.uniform(k_p, (T, b)))
    mb = cfg.minibatch if cfg.replay_size > 0 else 2 * T * b
    idx, tn = [], []
    for k_step in jax.random.split(k_upd, cfg.update_steps):
        k_mb, k_tn = jax.random.split(k_step)
        idx.append(jax.random.randint(k_mb, (mb,), 0, jnp.maximum(jnp.int32(filled), 1)))
        tn.append(jax.random.normal(k_tn, (mb, A)))
    d.update(sample_idx=jnp.stack(idx), target_noise=jnp.stack(tn))
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items() if k != 'relabel'}
    out['relabel'] = tuple(torch.from_numpy(np.asarray(v)) for v in d['relabel'])
    out['sample_idx'] = out['sample_idx'].long()
    return out


ITERS = 2  # train iterations compared: the second starts from the first's Adam moments and buffer
BASE = dict(obs_dim=2, goal_dim=2, action_dim=2, hidden=(32, 32), action_scale=3.0, rollout_steps=3, update_steps=2,
            replay_size=4096, minibatch=256)
#: name -> (HERConfig overrides, fused step)
STEP_CASES = {
    'eager': ({}, False),
    'fused': ({}, True),
    # TD3 with n-step backups and episode-held exploration (a window with
    # ended episodes: both HER quirks of the JAX step, the redraw at the
    # window's start and the 0.0 actor loss of a skipped actor step)
    'td3_nstep_per_episode': (dict(twin_critic=True, target_noise=0.2, noise_clip=0.25, policy_delay=2, n_step=2,
                                   explore_per_episode=True, explore_eps=0.5), True),
}


@pytest.mark.parametrize('name', sorted(STEP_CASES))
def test_train_step_matches_jax(name, monkeypatch):
    """Two ``make_train_step`` iterations on small planning (3x3, 1 mover,
    ``std_noise=0``, 4 cycles, 16 envs, 3 rollout steps, 2 updates, replay
    4096, minibatch 256), over the eager ``step_autoreset`` or the fused
    step (the JAX step in interpret mode, all-zero hardware bits; the port's
    plain kernel F given all-zero uniforms alike), every draw of the JAX
    step handed to the port.

    Tolerances: env state and observations rtol 2e-6 / atol 2e-6 (the
    eager-vs-fused contract of ulp-level differences); rewards, flags,
    relabelled fraction and the buffer's ``ptr``/``filled`` exact; the
    buffer's rows rtol 1e-5 / atol 1e-6 (actions from the actor's float32
    products); losses rtol 1e-4 (after Adam steps on gradients that agree
    to ~1e-6); weights rtol 1e-5 / atol 2e-7: Adam moves a weight by about
    lr * g / (|g| + eps), +-lr where |g| dwarfs eps, so gradients that differ
    in rounding give updates a few ulps apart."""
    over, fused = STEP_CASES[name]
    cfg = jher.HERConfig(**dict(BASE, **over))
    b = 16
    kw = dict(std_noise=0.0, num_cycles=4, a_max=3.0)
    jcfg, jprm = jplan.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.ones((3, 3)), 1, device='cpu', **kw)
    g = torch.Generator().manual_seed(11)
    state, _, _ = tplan.init_batch(tcfg, tprm, b, g)
    # movers near the table's centre, goals 0.3 m away: no episode ends
    # by itself within the window (the eager steps restart from different
    # generators)
    rng = np.random.default_rng(12)
    state.pos = torch.from_numpy(rng.uniform(0.33, 0.39, (b, 1, 2)).astype(np.float32))
    state.goals = torch.full((b, 1, 2), 0.15)
    if 'per_episode' in name:
        # a quarter of the envs one step from the time limit: episodes end
        # inside the window
        state.steps[:b // 4] = tcfg.max_episode_steps - 1
    obs = tplan._get_obs(tcfg, tprm, state, g)
    jstate = jplan.PlanningState(**{k: jnp.asarray(v) for k, v in tplan.state_to_numpy(state).items()},
                                 key=jax.random.split(jax.random.PRNGKey(0), b))
    jobs = {k: jnp.asarray(v.numpy()) for k, v in obs.items()}

    def jreward(ach, des, mc, wc):
        return jplan.compute_reward(jcfg, jprm, ach, des, mc, wc)

    def treward(ach, des, mc, wc):
        return tplan.compute_reward(tcfg, tprm, ach, des, mc, wc)

    jpar = jher.init_params(jax.random.PRNGKey(2), cfg)
    if fused:
        monkeypatch.setattr(kernels, 'draw_uniforms',
                            lambda n, batch, device, generator=None: torch.zeros((n, batch), device=device))
        jfused = jplan.make_fused_step_autoreset(jcfg, jprm, interpret=True)
        tfused = tplan.make_fused_step_autoreset(tcfg, tprm)
        jstep, (a_opt, c_opt) = jher.make_train_step(jcfg, jprm, cfg, None, jreward, lambda r: jnp.abs(r) == 50.0,
                                                     batched_step_fn=jfused)
        tstep, make_opts = ther.make_train_step(tcfg, tprm, tcfg_of(cfg), None, treward,
                                                lambda r: torch.abs(r) == 50.0,
                                                batched_step_fn=lambda s, a: tfused(s, a, generator=g))
    else:
        jstep, (a_opt, c_opt) = jher.make_train_step(jcfg, jprm, cfg, jplan.step_autoreset, jreward,
                                                     lambda r: jnp.abs(r) == 50.0)
        tstep, make_opts = ther.make_train_step(tcfg, tprm, tcfg_of(cfg), tplan.step_autoreset, treward,
                                                lambda r: torch.abs(r) == 50.0)
    jrunner = (jstate, jobs, jpar, a_opt.init(jpar['actor']), c_opt.init(jpar['critic']), jher.init_replay(cfg),
               jax.random.PRNGKey(9))
    nets = ther.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpar), device='cpu')
    runner = (state, obs, nets, *make_opts(nets), ther.init_replay(tcfg_of(cfg), device='cpu'), g)
    jstep = jax.jit(jstep)
    for it in range(ITERS):
        draws = jax_draws(jrunner[-1], cfg, b, 2 * 3 * b * (it + 1))
        jrunner, jm = jstep(jrunner)
        runner, tm = tstep(runner, draws=draws)
    jstate2, jobs2, jpar2, _, _, jbuf, _ = jrunner
    tstate2, tobs2, nets2, _, _, tbuf, _ = runner

    # an episode ended where the counter restarted or passed the limit (a
    # stalled restart keeps counting)
    steps2 = np.asarray(jstate2.steps)
    ended = (steps2 < 3 * ITERS) | (steps2 >= tcfg.max_episode_steps)
    if 'per_episode' in name:
        assert ended.sum() == b // 4 and float(tm['actor_loss']) == float(jm['actor_loss']) == 0.0
    else:
        assert not ended.any()
    for f in ('pos', 'vel', 'acc', 'goals'):
        np.testing.assert_allclose(getattr(tstate2, f).numpy(), np.asarray(getattr(jstate2, f)), rtol=2e-6,
                                   atol=2e-6, err_msg=f)
    np.testing.assert_array_equal(tstate2.steps.numpy(), np.asarray(jstate2.steps))
    for k in tobs2:
        np.testing.assert_allclose(tobs2[k].numpy(), np.asarray(jobs2[k]), rtol=2e-6, atol=2e-6, err_msg=k)
    n = 2 * 3 * b * ITERS
    assert (tbuf['ptr'], tbuf['filled']) == (int(jbuf['ptr']), int(jbuf['filled'])) == (n, n)
    for f in ther.REPLAY_FIELDS:
        np.testing.assert_allclose(tbuf[f][:n].numpy(), np.asarray(jbuf[f])[:n], rtol=1e-5, atol=1e-6, err_msg=f)
    for k in ('reward_mean', 'success_rate', 'episode_success_rate', 'collision_rate', 'relabeled_frac',
              'relabel_reward_mean'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    for k in ('critic_loss', 'actor_loss'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    moved = 0
    for got, want, old in zip(leaves(ther.params_to_numpy(nets2)), leaves(jpar2), leaves(jpar)):
        moved += np.abs(want - old).max() > 0.5 * cfg.critic_lr * cfg.tau
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-7)
    assert moved == len(leaves(jpar))  # every leaf, targets too, moved


def test_train_push_her_tool_smoke():
    """``train_push_her.main`` at 2 iterations on the CPU (plain kernel C):
    the JAX tool's flags, its JSON summary's keys, and the replay buffer
    holding both iterations' originals and relabelled copies."""
    argv = ['--device', 'cpu', '--iters', '2', '--batch', '4', '--replay', '4096', '--minibatch', '64',
            '--update-steps', '2', '--eval-every', '2', '--eval-episodes', '4', '--hidden', '16', '16', '--twin',
            '--target-noise', '0.1', '--policy-delay', '2']
    out = train_push_her.main(argv)
    assert set(out) == {'metric', 'value', 'env_steps', 'wall_s', 'recipe'} and out['env_steps'] == 2 * 4 * 50
    assert 0.0 <= out['value'] <= 1.0
    jax_flags = {'iters', 'batch', 'hidden', 'gamma', 'tau', 'actor_lr', 'critic_lr', 'relabel', 'explore_std',
                 'explore_eps', 'update_steps', 'replay', 'minibatch', 'action_l2', 'twin', 'target_noise',
                 'policy_delay', 'n_step', 'per_episode', 'fused', 'eval_every', 'eval_episodes', 'seed'}
    assert set(out['recipe']) == jax_flags | {'device'}
    args = train_push_her.parser().parse_args(argv)
    _, _, cfg, step, runner = train_push_her.build(args)
    assert cfg.rollout_steps == 50 and cfg.obs_dim + 2 * cfg.goal_dim == 12
    before = kernels.LAUNCHES['pushing_autoreset']
    runner, m = step(runner)
    assert runner[5]['filled'] == 2 * 50 * 4 and np.isfinite(float(m['critic_loss']))
    assert kernels.LAUNCHES['pushing_autoreset'] == before  # the plain version on the CPU
    with pytest.raises(ValueError, match='batched_step_fn'):
        ther.make_train_step(None, None, cfg, None, None, None)


def test_train_pushing_and_eval_in_engine_run():
    """``transfer_eval.train_pushing`` (DDPG+HER with the 4M replay buffer on
    the eager pushing step) for one iteration at 2 envs, then
    ``eval_in_engine`` of its policy (the episode loop it shares with
    ``train_push_strong.make_eval``, held against the JAX package's in
    ``test_torch_train_push_strong.py``): every episode ends within the
    horizon, the rates are shares of the episodes."""
    lines = []
    policy, (config, params) = transfer_eval.train_pushing(iters=1, batch=2, log=lines.append, device='cpu')
    assert len(lines) == 1 and 'ep-success' in lines[0]
    assert config.reward_mode == 'sparse' and float(params.threshold_pos) == np.float32(0.05)
    res = transfer_eval.eval_in_engine(tpush, config, params, policy, 4)
    assert res['episodes'] == 4 and 0.0 <= res['success'] <= res['success_any'] <= 1.0
    assert -50.0 * transfer_eval.HORIZON <= res['return_mean'] <= 0.0
    vec = torch.zeros((3, 8))
    assert policy(vec).shape == (3, 2) and float(policy(vec).abs().max()) <= transfer_eval.PUSHING_KW['a_max']


def jax_gate(seed: int, iters: int = 250) -> dict:
    """The JAX package's HER learning gate (``tests/test_her_learning.py``'s
    learner and thresholds) with both learners' keys from ``seed``."""
    config, params = jplan.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32, a_max=3.0)

    def run(relabel_prob):
        cfg = jher.HERConfig(obs_dim=2, goal_dim=2, action_dim=2, hidden=(64, 64), action_scale=3.0,
                             rollout_steps=16, relabel_prob=relabel_prob, explore_std=0.2, update_steps=8)
        pol = jher.init_params(jax.random.PRNGKey(seed), cfg)
        step, (a_opt, c_opt) = jher.make_train_step(
            config, params, cfg, jplan.step_autoreset,
            lambda ach, des, mc, wc: jplan.compute_reward(config, params, ach, des, mc, wc),
            lambda r: jnp.abs(r) == 50.0)
        state, obs, _ = jplan.init_batch(config, params, jax.random.PRNGKey(seed + 1), 256)
        runner = (state, obs, pol, a_opt.init(pol['actor']), c_opt.init(pol['critic']), jax.random.PRNGKey(seed + 2))
        step = jax.jit(step)
        rates = []
        for _ in range(iters):
            runner, m = step(runner)
            rates.append(float(m['episode_success_rate']))
        return np.asarray(rates)

    rates, no_her = run(0.8), run(0.0)
    early, late, late_no = float(rates[10:40].mean()), float(rates[-30:].mean()), float(no_her[-30:].mean())
    return {'seed': seed, 'iters': iters, 'early': early, 'late': late, 'late_no_relabel': late_no,
            'lift_held': late > early + 0.08, 'level_held': late > 0.38, 'relabel_held': late > late_no + 0.10}


if __name__ == '__main__':
    # the JAX package's HER gate at other seeds, on the CPU with x64 as the
    # suite runs it (tests/conftest.py): python tests/test_torch_her.py [--iters N] SEED ...
    import argparse
    import json

    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    ap = argparse.ArgumentParser()
    ap.add_argument('seeds', type=int, nargs='+')
    ap.add_argument('--iters', type=int, default=250)
    cli = ap.parse_args()
    for s in cli.seeds:
        print(json.dumps(jax_gate(s, cli.iters)), flush=True)
