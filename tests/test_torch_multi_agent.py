"""Port parity: ``multi_agent.make_batched_parallel_step`` where no fused
kernel applies (f64 params, more than 8 movers) steps through the eager
``planning.batched_step_autoreset``, as the JAX package falls back to its
XLA path (``models/multi_agent.py:74-90``; on the CPU the JAX step always
takes that path).

The port's step is handed JAX's own normals (each env's key split as the
JAX step splits it, ``test_torch_planning_step.jax_noise``) through
``noise=``, and held at that file's eager tolerances on every env that has
not ended an episode (restarts draw from different generators).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import multi_agent as jma
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.models import multi_agent as tma
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan

from test_torch_planning_step import assert_states, jax_noise, to_jax, tols

# name -> (layout, movers, dtype)
CASES = {
    'm9_f32': (np.ones((6, 6)), 9, 'float32'),
    'm9_f64': (np.ones((6, 6)), 9, 'float64'),
    'm2_f64': (np.ones((3, 3)), 2, 'float64'),
}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize('name', sorted(CASES))
def test_fallback_matches_jax_parallel_step(name):
    layout, m, dtype = CASES[name]
    kw = dict(num_cycles=8, std_noise=[1e-4, 1e-3, 1e-5])
    jcfg, jprm = jplan.make_planning_env(layout, m, dtype=jnp.dtype(dtype), **kw)
    tcfg, tprm = tplan.make_planning_env(layout, m, dtype=getattr(torch, dtype), device='cpu', **kw)
    assert not tma.fused_covers(tcfg, tprm)
    b = 32
    g = torch.Generator().manual_seed(1)
    state, _, _ = tplan.init_batch(tcfg, tprm, b, g)
    # a quarter of the envs with mover 0 driven out over the -x wall
    q = b // 4
    state.pos[:q, 0, 0] = 0.12
    state.vel[:q, 0] = torch.tensor([-1.5, 0.0], dtype=state.pos.dtype)
    jstate = to_jax(state, 2)
    jstep = jax.jit(jma.make_batched_parallel_step(jcfg, jprm, jit=False))
    tstep = tma.make_batched_parallel_step(tcfg, tprm)
    assert tstep.noise_planes is None
    rng = np.random.default_rng(3)
    tol, tol_acc = tols(dtype)
    live = np.ones(b, bool)
    ends = 0
    for _ in range(4):
        act = rng.uniform(-3.0, 3.0, (b, m, 2)).astype(dtype)
        noise = jax_noise(jstate.key, tcfg, dtype)
        jstate, jout = jstep(jstate, jnp.asarray(act))
        state, tout = tstep(state, torch.from_numpy(act), noise=noise, generator=g)
        assert tout.reward.shape == (b, m) and tout.observation.dtype == getattr(torch, dtype)
        for k in ('reward', 'terminated', 'truncated'):
            np.testing.assert_array_equal(getattr(tout, k).numpy()[live], np.asarray(getattr(jout, k))[live],
                                          err_msg=k)
        done = (tout.terminated | tout.truncated)[:, 0].numpy() & live
        ends += int(done.sum())
        live &= ~done
        assert_states(state, jstate, dtype, live)
        for k in ('observation', 'achieved_goal', 'desired_goal'):
            np.testing.assert_allclose(getattr(tout, k).numpy()[live], np.asarray(getattr(jout, k))[live],
                                       **tol_acc, err_msg=k)
    assert ends >= q and live.any(), (ends, live.sum())


def test_fused_step_is_kept_where_a_kernel_covers():
    """f32 with 2-8 movers still takes kernel H (the plain version here):
    the step exposes the fused step's noise plane count."""
    tcfg, tprm = tplan.make_planning_env(np.ones((4, 4)), 4, num_cycles=4, device='cpu')
    assert tma.fused_covers(tcfg, tprm)
    step = tma.make_batched_parallel_step(tcfg, tprm)
    assert step.noise_planes == tplan.make_fused_step_autoreset(tcfg, tprm).noise_planes
    state, _, _ = tplan.init_batch(tcfg, tprm, 8, torch.Generator().manual_seed(4))
    u = torch.rand((step.noise_planes, 8), generator=torch.Generator().manual_seed(5))
    s1, o1 = step(state, torch.zeros((8, 4, 2)), noise=u)
    s2, *_ = tplan.make_fused_step_autoreset(tcfg, tprm)(state, torch.zeros((8, 8)), noise=u)
    torch.testing.assert_close(s1.pos, s2.pos, rtol=0, atol=0)
    assert o1.reward.shape == (8, 4)
