"""Port parity: ``models/ppo.py`` (actor-critic, sampling, GAE, loss,
gradients, Adam, the reactive train step) against the JAX package's.

Weights cross over through the JAX layout (``params_from_numpy``), noise is
made with numpy and handed to both.  Tolerances: forward passes rtol 1e-5
(float32 products summed in another order); the loss rtol 1e-5, its
gradients rtol 1e-4 / atol 1e-7 (autograd and XLA's transpose sum in other
orders).  The whole train step is compared in its own test, whose docstring
gives its tolerances.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from gymnasium_planar_robotics_tpu.models import ppo as jppo
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import ppo as tppo
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels

CFG = jppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(32, 24), rollout_steps=3, update_epochs=2)
TCFG = tppo.PPOConfig(**dataclasses.asdict(CFG))
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def policies(seed=0, cfg=CFG):
    """The same weights in both packages; the heads scaled up from their
    near-zero initialisation so that every term of the loss is exercised."""
    jpol = jppo.init_params(jax.random.PRNGKey(seed), cfg)
    jpol['mu']['w'] = jpol['mu']['w'] * 50.0
    jpol['mu']['b'] = jnp.asarray([0.3, -0.2], jnp.float32)
    jpol['log_std'] = jnp.asarray([-0.4, 0.2], jnp.float32)
    return jpol, tppo.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpol), device='cpu')


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_converters_round_trip_and_init_distributions():
    jpol, tpol = policies()
    for got, want in zip(leaves(tppo.params_to_numpy(tpol)), leaves(jpol)):
        np.testing.assert_array_equal(got, want)
    assert tpol.trunk[0].weight.shape == (32, 12) and tpol.mu.weight.shape == (2, 24)
    pol = tppo.init_params(tppo.PPOConfig(obs_dim=64, action_dim=2, hidden=(512, 512)),
                           torch.Generator().manual_seed(0), device='cpu')
    back = tppo.params_from_numpy(tppo.params_to_numpy(pol), device='cpu')
    for a, b in zip(pol.parameters(), back.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the JAX package's distributions: N(0, 2/fan_in) trunk, N(0, 1e-4) mu,
    # N(0, 1) value, zero biases and log_std
    for w, std in ((pol.trunk[0].weight.detach(), (2 / 64) ** 0.5), (pol.trunk[1].weight.detach(), (2 / 512) ** 0.5),
                   (pol.mu.weight.detach(), 0.01), (pol.value.weight.detach(), 1.0)):
        assert abs(float(w.std()) / std - 1) < (0.05 if w.numel() > 1000 else 0.6) and abs(float(w.mean())) < std / 3
    assert all(not p.detach().any() for p in (pol.trunk[0].bias, pol.mu.bias, pol.value.bias, pol.log_std))


def test_apply_and_apply_pm_match_jax():
    jpol, tpol = policies(1)
    obs = np.random.default_rng(0).normal(size=(3, 50, 12)).astype(np.float32)
    with torch.no_grad():
        for got, want in zip(tppo.apply(tpol, torch.from_numpy(obs)), jppo.apply(jpol, jnp.asarray(obs))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
        x = obs[0].T.copy()
        for got, want in zip(tppo.apply_pm(tpol, torch.from_numpy(x)), jppo.apply_pm(jpol, jnp.asarray(x))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_sample_action_pm_with_given_noise_matches_jax():
    """``sample_action_pm`` on given noise against the JAX train step's
    policy step (the float-noise branch): action, raw sample, log-prob,
    value; the noise is large enough that the clip fires."""
    jpol, tpol = policies(2)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 300)).astype(np.float32)
    eps = (rng.normal(size=(2, 300)) * 8).astype(np.float32)
    jstep, _ = jppo.make_train_step_reactive(CFG, lambda ps: ps)
    ja, (jraw, jlogp, jval) = jstep.policy_step(jpol, jnp.asarray(eps), jnp.asarray(x))
    with torch.no_grad():
        ta, traw, tlogp, tval = tppo.sample_action_pm(tpol, torch.from_numpy(x), torch.from_numpy(eps),
                                                      CFG.action_scale)
    for got, want in ((ta, ja), (traw, jraw), (tlogp, jlogp), (tval, jval)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert float(traw.abs().max()) > CFG.action_scale and float(ta.abs().max()) == CFG.action_scale
    # a generator draws the noise itself, reproducibly
    with torch.no_grad():
        a1 = tppo.sample_action_pm(tpol, torch.from_numpy(x), torch.Generator().manual_seed(3), 10.0)[1]
        a2 = tppo.sample_action_pm(tpol, torch.from_numpy(x), torch.Generator().manual_seed(3), 10.0)[1]
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)


def test_compute_gae_matches_jax():
    """Terminations, truncations, and both at once on one step."""
    T, b = 6, 40
    rng = np.random.default_rng(2)
    term = rng.random((T, b)) < 0.15
    trunc = rng.random((T, b)) < 0.15
    term[2, :5] = trunc[2, :5] = True  # both at once
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    vals = dict(obs=f(T, b, 12), raw_action=f(T, b, 2), logp=f(T, b), value=f(T, b), reward=f(T, b),
                terminated=term, truncated=trunc, final_value=f(T, b))
    last = f(b)
    jadv, jret = jppo.compute_gae(jppo.Transition(**{k: jnp.asarray(v) for k, v in vals.items()}), jnp.asarray(last),
                                  0.99, 0.95)
    tadv, tret = tppo.compute_gae(tppo.Transition(**{k: torch.from_numpy(v) for k, v in vals.items()}),
                                  torch.from_numpy(last), 0.99, 0.95)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **FWD)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), **FWD)


def _loss_batch(seed, n=256):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 12)).astype(np.float32), (rng.normal(size=(n, 2)) * 2).astype(np.float32),
            (rng.normal(size=n) - 3).astype(np.float32), (rng.normal(size=n) * 3 + 1).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def test_ppo_loss_and_gradients_match_jax():
    """The advantages are normalised by the population std (``jnp.std``);
    torch's default std is the unbiased one."""
    cfg = dataclasses.replace(CFG, entropy_coef=0.01)
    jpol, tpol = policies(3)
    batch = _loss_batch(4)
    jloss, jgrad = jax.value_and_grad(jppo.ppo_loss)(jpol, cfg, tuple(jnp.asarray(x) for x in batch))
    tloss = tppo.ppo_loss(tpol, tppo.PPOConfig(**dataclasses.asdict(cfg)), tuple(torch.from_numpy(x) for x in batch))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    tgrad = {'trunk': [{'w': l.weight.grad.numpy().T, 'b': l.bias.grad.numpy()} for l in tpol.trunk],
             'mu': {'w': tpol.mu.weight.grad.numpy().T, 'b': tpol.mu.bias.grad.numpy()},
             'value': {'w': tpol.value.weight.grad.numpy().T, 'b': tpol.value.bias.grad.numpy()},
             'log_std': tpol.log_std.grad.numpy()}
    for got, want in zip(leaves(tgrad), leaves(jgrad)):
        np.testing.assert_allclose(got, want, **GRAD)
    # the ratio clip fires in both directions on this batch
    with torch.no_grad():
        mu, log_std, _ = tppo.apply(tpol, torch.from_numpy(batch[0]))
        ratio = torch.exp(tppo._gaussian_logp(torch.from_numpy(batch[1]), mu, log_std) - torch.from_numpy(batch[2]))
    assert (ratio > 1.2).any() and (ratio < 0.8).any()


def test_adam_step_matches_optax():
    """One step of ``make_optimizer``'s Adam against ``optax.adam`` on the
    same gradients: rtol 1e-6 / atol 1e-9 on the weights (the update is
    +-lr where the gradient dwarfs eps, so only rounding can differ)."""
    jpol, tpol = policies(5)
    batch = _loss_batch(6)
    jgrad = jax.grad(jppo.ppo_loss)(jpol, CFG, tuple(jnp.asarray(x) for x in batch))
    opt = optax.adam(CFG.learning_rate)
    updates, _ = opt.update(jgrad, opt.init(jpol), jpol)
    jnew = optax.apply_updates(jpol, updates)
    topt = tppo.make_train_step_reactive(TCFG, lambda ps: ps)[1](tpol)
    # the gradients in the module's layout, through the converter
    grads = tppo.params_from_numpy(jax.tree_util.tree_map(np.asarray, jgrad), device='cpu')
    for p, g in zip(tpol.parameters(), grads.parameters()):
        p.grad = g.detach().clone()
    topt.step()
    for got, want in zip(leaves(tppo.params_to_numpy(tpol)), leaves(jnew)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_reactive_train_step_matches_jax(monkeypatch):
    """One ``make_train_step_reactive`` iteration on the dense pushing
    rollout (B=128, T=3, 4 cycles, ``std_noise=0``), the JAX step run as it
    is under ``jax.jit`` (interpret-mode kernels, all-zero hardware bits;
    the port's plain versions are given all-zero uniforms alike), the port
    given the JAX step's own exploration noise (its key split as in
    ``ppo.py:208-212``).

    Tolerances: metrics rtol 1e-4 (the loss of the last epoch, after one
    Adam step on gradients that agree to ~1e-5); env state rtol 3e-5 / atol
    3e-6 (the rollout contract); weights rtol 1e-5 / atol 2e-7: Adam moves
    a weight by about lr * g / (|g| + eps), +-lr (3e-4) where |g| dwarfs
    eps, so gradients that differ in rounding give updates that differ by
    a few ulps of the weight (6e-8 seen); only a gradient within a few eps
    of 0 could move one weight's update by a part of lr."""
    monkeypatch.setattr(kernels, 'draw_uniforms',
                        lambda n, batch, device, generator=None: torch.zeros((n, batch), device=device))
    kw = dict(std_noise=0.0, num_cycles=4)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(device='cpu', **kw)
    b = 128
    state, _, _ = tpush.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(7))
    jpol, tpol = policies(8)

    jtrain, jopt = jppo.make_train_step_reactive(CFG, lambda ps: jpush.make_reactive_rollout(
        jcfg, jprm, ps, CFG.rollout_steps, interpret=True, dense_reward=True))
    jstate = jpush.PushingState(**{k: jnp.asarray(v) for k, v in tpush.state_to_numpy(state).items()},
                                key=jax.random.split(jax.random.PRNGKey(0), b))
    key = jax.random.PRNGKey(9)
    (jstate2, jpol2, _, _, jseed), jm = jax.jit(jtrain)((jstate, jpol, jopt.init(jpol), key, jnp.asarray(5)))
    _, k_roll = jax.random.split(key)
    eps = np.array(jax.random.normal(k_roll, (CFG.rollout_steps, CFG.action_dim, b), jnp.float32))

    ttrain, make_opt = tppo.make_train_step_reactive(TCFG, lambda ps: tpush.make_reactive_rollout(
        tcfg, tprm, ps, TCFG.rollout_steps, dense_reward=True))
    (tstate2, tpol2, _, _, tseed), tm = ttrain((state, tpol, make_opt(tpol), None, 5), eps=torch.from_numpy(eps))

    assert tseed == int(jseed) == 5 + CFG.rollout_steps
    assert float(tm['done_rate']) == float(jm['done_rate']) == 0.0
    for k in ('loss', 'reward_mean'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    for f in dataclasses.fields(tstate2):
        np.testing.assert_allclose(getattr(tstate2, f.name).numpy(), np.asarray(getattr(jstate2, f.name)),
                                   rtol=3e-5, atol=3e-6, err_msg=f.name)
    for got, want, old in zip(leaves(tppo.params_to_numpy(tpol2)), leaves(jpol2), leaves(jpol)):
        assert np.abs(want - old).max() > 0.5 * CFG.learning_rate  # every leaf moved
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-7)


def test_make_train_step_over_the_fused_planning_step():
    """``make_train_step`` over the port's fused planning step (kernel F's
    plain version here) runs and gives finite metrics; so does it over the
    eager ``step_autoreset``, which draws from the runner's generator."""
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, num_cycles=4, reward_mode='dense', device='cpu')
    pcfg = tppo.PPOConfig(obs_dim=6, action_dim=2, hidden=(16, 16), rollout_steps=4, update_epochs=2)
    g = torch.Generator().manual_seed(0)
    state, obs, _ = tplan.init_batch(cfg, prm, 130, g)
    step = tplan.make_fused_step_autoreset(cfg, prm)
    train, make_opt = tppo.make_train_step(cfg, prm, pcfg, batched_step_fn=lambda s, a: step(s, a, generator=g))
    pol = tppo.init_params(pcfg, g, device='cpu')
    obs_vec = torch.cat([obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1)
    runner = (state, obs_vec, pol, make_opt(pol), g)
    before = [p.detach().clone() for p in pol.parameters()]
    for _ in range(2):
        runner, m = train(runner)
        assert all(np.isfinite(float(v)) for v in m.values())
    assert all(not torch.equal(a, p) for a, p in zip(before, pol.parameters()))
    assert runner[1].shape == (130, 6)
    train, make_opt = tppo.make_train_step(cfg, prm, pcfg, step_autoreset_fn=tplan.step_autoreset)
    runner, m = train((state, obs_vec, pol, make_opt(pol), g))
    assert all(np.isfinite(float(v)) for v in m.values()) and runner[0].pos.shape == (130, 1, 2)
    with pytest.raises(ValueError, match='batched_step_fn'):
        tppo.make_train_step(cfg, prm, pcfg)
