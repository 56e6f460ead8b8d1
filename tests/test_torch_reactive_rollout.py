"""Port parity: the reactive (policy-in-the-loop) rollouts,
``pushing.make_reactive_rollout`` on kernel C-feat and
``planning.make_reactive_rollout`` on kernel F.

- A constant policy gives ``make_fused_rollout`` at K=1 bit for bit (both
  drive the same kernel with the same seeds), as the JAX package's own
  ``tests/test_reactive_rollout.py`` checks.
- Against the JAX package's reactive rollout (interpret mode) on the same
  state, with PPO weights carried over and the same exploration noise
  (``policy_xs``), at ``std_noise=0``: the interpret-mode hardware PRNG
  gives all-zero bits, so the port's plain versions are given all-zero
  uniforms too (``kernels.draw_uniforms`` patched), and the observation
  noise and the restart draws are the same in both.  Tolerance rtol 3e-5,
  atol 3e-6: the kernels' planes differ at the ulp (FMA contraction), the
  policies' matrix products sum in another order, and three steps of contact
  amplify both a little (the JAX package's rollout-vs-step contract).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.models import ppo as jppo
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import ppo as tppo
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels

TOL = dict(rtol=3e-5, atol=3e-6)
T = 3


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The port's plain versions draw all-zero uniforms, as the JAX kernels'
    hardware PRNG gives all-zero bits in interpret mode."""
    monkeypatch.setattr(kernels, 'draw_uniforms',
                        lambda n, batch, device, generator=None: torch.zeros((n, batch), device=device))


def push_env(device='cpu', **kw):
    return tpush.make_pushing_env(std_noise=1e-5, num_cycles=4, device=device, **kw)


def plan_env(device='cpu', **kw):
    return tplan.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, num_cycles=4, device=device, **kw)


def constant_policy(action):
    def policy_step(pol, gen, obs_pm):
        return action.expand(2, obs_pm.shape[1]), ()

    return policy_step


def test_constant_policy_matches_fused_rollout_pushing():
    cfg, prm = push_env()
    b = 200  # not a multiple of 128: no padding anywhere
    state, _, _ = tpush.init_batch(cfg, prm, b, torch.Generator().manual_seed(0))
    state.steps[::7] = cfg.max_episode_steps - 2  # truncation restarts in step 2
    state.pos[1::5, 0] = 0.112
    state.vel[1::5] = torch.tensor([-1.0, 0.0])  # wall hits
    action = torch.tensor([[2.0], [1.0]])
    final_r, traj, last = tpush.make_reactive_rollout(cfg, prm, constant_policy(action), T)(state, None, None, 7)
    obs, aux, rew_r, term_r, trunc_r, fin = traj
    final_f, rew_f, term_f, trunc_f = tpush.make_fused_rollout(cfg, prm)(state, action.T.expand(T, b, 2), 7)
    for f in dataclasses.fields(final_f):
        torch.testing.assert_close(getattr(final_r, f.name), getattr(final_f, f.name), rtol=0, atol=0)
    for got, want in ((rew_r, rew_f), (term_r, term_f), (trunc_r, trunc_f)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert term_r.any() and trunc_r.any() and aux == ()
    assert obs.shape == fin.shape == (T, b, 12) and last.shape == (b, 12) and rew_r.dtype == torch.float32
    # the first observation is the noise-free state
    torch.testing.assert_close(obs[0, :, :2], state.pos, rtol=0, atol=0)
    torch.testing.assert_close(obs[0, :, 6:8], state.goal, rtol=0, atol=0)
    torch.testing.assert_close(obs[0, :, 10:12], state.goal - state.obj_pos, rtol=0, atol=0)


def test_constant_policy_matches_fused_rollout_planning():
    cfg, prm = plan_env()
    b = 200
    state, _, _ = tplan.init_batch(cfg, prm, b, torch.Generator().manual_seed(0))
    state.steps[::7] = cfg.max_episode_steps - 2
    state.pos[1::5, 0, 0] = 0.112
    state.vel[1::5, 0] = torch.tensor([-1.0, 0.0])
    action = torch.tensor([[3.0], [-2.0]])
    final_r, traj, last = tplan.make_reactive_rollout(cfg, prm, constant_policy(action), T)(state, None, None, 3)
    obs, aux, rew_r, term_r, trunc_r, fin = traj
    final_f, rew_f, term_f, trunc_f = tplan.make_fused_rollout(cfg, prm)(state, action.T.expand(T, b, 2), 3)
    for f in dataclasses.fields(final_f):
        torch.testing.assert_close(getattr(final_r, f.name), getattr(final_f, f.name), rtol=0, atol=0)
    for got, want in ((rew_r, rew_f), (term_r, term_f), (trunc_r, trunc_f)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert term_r.any() and trunc_r.any()
    assert obs.shape == fin.shape == (T, b, 6) and last.shape == (b, 6)


def test_reactive_rollout_limits():
    """As in the JAX package: acc mode and f32 only; planning: 1 mover."""
    policy = constant_policy(torch.zeros(2, 1))
    for cfg, prm in (push_env(learn_jerk=True), push_env(dtype=torch.float64)):
        with pytest.raises(ValueError, match='acc mode|f32'):
            tpush.make_reactive_rollout(cfg, prm, policy, 2)


def _jax_state(module, tstate, b):
    d = {f.name: jnp.asarray(getattr(tstate, f.name).numpy()) for f in dataclasses.fields(tstate)}
    return module.PushingState(**d, key=jax.random.split(jax.random.PRNGKey(0), b)) if module is jpush else \
        module.PlanningState(**d, key=jax.random.split(jax.random.PRNGKey(0), b))


@pytest.mark.parametrize('family,dense,b', [('pushing', False, 128), ('pushing', True, 200), ('planning', True, 128),
                                            ('planning', False, 200)])
def test_reactive_rollout_matches_jax(zero_uniforms, family, dense, b):
    """PPO's policy step with carried weights and the same noise; ``b=200``
    is not a multiple of 128 (the JAX rollout pads, the port does not).  The
    JAX rollout pads the state but not ``policy_xs``, so its noise is padded
    here to the multiple of 128 (zeros in the pad lanes)."""
    kw = dict(std_noise=0.0, num_cycles=4)
    if family == 'pushing':
        jmod, tmod, obs_dim = jpush, tpush, 12
        jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
        tcfg, tprm = tpush.make_pushing_env(device='cpu', **kw)
    else:
        jmod, tmod, obs_dim = jplan, tplan, 6
        jcfg, jprm = jplan.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float32, **kw)
        tcfg, tprm = tplan.make_planning_env(np.ones((3, 3)), 1, device='cpu', **kw)
    state, _, _ = tmod.init_batch(tcfg, tprm, b, torch.Generator().manual_seed(4))
    pcfg = dict(obs_dim=obs_dim, action_dim=2, hidden=(32, 32), rollout_steps=T)
    jpol = jppo.init_params(jax.random.PRNGKey(5), jppo.PPOConfig(**pcfg))
    tpol = tppo.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpol), device='cpu')
    eps = np.random.default_rng(6).standard_normal((T, 2, b)).astype(np.float32)
    eps_padded = np.zeros((T, 2, -(-b // 128) * 128), np.float32)
    eps_padded[..., :b] = eps

    jstep, _ = jppo.make_train_step_reactive(jppo.PPOConfig(**pcfg), lambda ps: ps)
    jroll = jmod.make_reactive_rollout(jcfg, jprm, jstep.policy_step, T, interpret=True, dense_reward=dense)
    jfinal, jtraj, jlast = jax.jit(lambda s, p, e: jroll(s, p, None, 11, policy_xs=e))(
        _jax_state(jmod, state, b), jpol, jnp.asarray(eps_padded))
    tstep, _ = tppo.make_train_step_reactive(tppo.PPOConfig(**pcfg), lambda ps: ps)
    with torch.no_grad():
        tfinal, ttraj, tlast = tmod.make_reactive_rollout(tcfg, tprm, tstep.policy_step, T, dense_reward=dense)(
            state, tpol, None, 11, policy_xs=torch.from_numpy(eps))

    (jobs, (jraw, jlogp, jval), jrew, jterm, jtrunc, jfin) = jtraj
    (tobs, (traw, tlogp, tval), trew, tterm, ttrunc, tfin) = ttraj
    if family == 'pushing':
        # no env ended in these three steps, so nothing restarted in either
        assert not np.asarray(jterm | jtrunc).any() and not (tterm | ttrunc).any()
    else:
        # goals reached from the start end some episodes: on all-zero draws
        # both restarts stall alike (start and goal candidates coincide)
        assert np.asarray(jterm).any()
    for name, got, want in (('obs_vec', tobs, jobs), ('raw', traw, jraw), ('logp', tlogp, jlogp),
                            ('value', tval, jval), ('reward', trew, jrew), ('final_vec', tfin, jfin),
                            ('last_obs_vec', tlast, jlast)):
        assert tuple(got.shape) == np.asarray(want).shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=name)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    for f in dataclasses.fields(tfinal):
        np.testing.assert_allclose(getattr(tfinal, f.name).numpy(), np.asarray(getattr(jfinal, f.name)), **TOL,
                                   err_msg=f.name)
    if dense:
        assert len(np.unique(trew.numpy())) > b  # shaped: a distance per env and step
