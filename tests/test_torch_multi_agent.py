"""Port parity: ``multi_agent.make_batched_parallel_step`` against the JAX
package's step on the CPU, which always takes its XLA fallback
(``models/multi_agent.py:74-90``).  Where no fused kernel applies (f64
params, more than ``planning_multi.MAX_MOVERS`` movers) the port steps
through the eager ``planning.batched_step_autoreset`` too; with f32 params
and at most ``MAX_MOVERS`` movers it keeps the fused step (kernel H), as the
JAX package does on its accelerator: case ``m65_f32``, 65 movers, now
covered by kernel H's L = 4 slots.

The eager cases hand the port JAX's own normals (each env's key split as
the JAX step splits it, ``test_torch_planning_step.jax_noise``) through
``noise=``; the fused case runs at ``std_noise=0``, where the noise cannot
matter, on uniforms of its own.  Both are held at that file's float32 or
float64 tolerances on every env that has not ended an episode (restarts
draw from different generators, and the fused step restarts in the kernel).
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
    'm9_f64': (np.ones((6, 6)), 9, 'float64'),
    'm2_f64': (np.ones((3, 3)), 2, 'float64'),
    'm65_f32': (np.ones((9, 9)), 65, 'float32'),
}


def initial_state(tcfg, tprm, side, b, g):
    """``init_batch``; above 9 movers, whose random start sets are never all
    apart, the movers start on the first M tile centres of the square table
    (row by row) with goals 16 centres further on."""
    m = tcfg.num_movers
    if m <= 9:
        return tplan.init_batch(tcfg, tprm, b, g)[0]
    t = 2 * float(tprm.grid.tile_size[0])  # tile_size holds half-sizes
    centres = [(t * (i + 0.5), t * (j + 0.5)) for j in range(side) for i in range(side)]
    return tplan.reset(tcfg, tprm, b, g, start_xy=centres[:m], goals_xy=centres[16:16 + m])[0]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize('name', sorted(CASES))
def test_fallback_matches_jax_parallel_step(name):
    layout, m, dtype = CASES[name]
    fused = dtype == 'float32'
    kw = dict(num_cycles=8, std_noise=0.0 if fused else [1e-4, 1e-3, 1e-5])
    jcfg, jprm = jplan.make_planning_env(layout, m, dtype=jnp.dtype(dtype), **kw)
    tcfg, tprm = tplan.make_planning_env(layout, m, dtype=getattr(torch, dtype), device='cpu', **kw)
    assert tma.fused_covers(tcfg, tprm) == fused
    b = 32
    g = torch.Generator().manual_seed(1)
    state = initial_state(tcfg, tprm, layout.shape[0], b, g)
    # a quarter of the envs with mover 0 driven out over the -x wall
    q = b // 4
    state.pos[:q, 0, 0] = 0.12
    state.vel[:q, 0] = torch.tensor([-1.5, 0.0], dtype=state.pos.dtype)
    jstate = to_jax(state, 2)
    jstep = jax.jit(jma.make_batched_parallel_step(jcfg, jprm, jit=False))
    tstep = tma.make_batched_parallel_step(tcfg, tprm)
    assert (tstep.noise_planes is not None) == fused
    rng = np.random.default_rng(3)
    tol, tol_acc = tols(dtype)
    live = np.ones(b, bool)
    ends = 0
    for _ in range(4):
        act = rng.uniform(-3.0, 3.0, (b, m, 2)).astype(dtype)
        if fused:
            noise = torch.rand((tstep.noise_planes, b), generator=g)
        else:
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


@pytest.mark.parametrize('m, side', [(4, 4), (9, 6)])
def test_fused_step_is_kept_where_a_kernel_covers(m, side):
    """f32 takes kernel H (the plain version here) at 4 movers and at 9,
    more than one thread per env was once instantiated for: the step
    exposes the fused step's noise plane count and steps as it does."""
    tcfg, tprm = tplan.make_planning_env(np.ones((side, side)), m, num_cycles=4, device='cpu')
    assert tma.fused_covers(tcfg, tprm)
    step = tma.make_batched_parallel_step(tcfg, tprm)
    assert step.noise_planes == tplan.make_fused_step_autoreset(tcfg, tprm).noise_planes
    state, _, _ = tplan.init_batch(tcfg, tprm, 8, torch.Generator().manual_seed(4))
    u = torch.rand((step.noise_planes, 8), generator=torch.Generator().manual_seed(5))
    s1, o1 = step(state, torch.zeros((8, m, 2)), noise=u)
    s2, *_ = tplan.make_fused_step_autoreset(tcfg, tprm)(state, torch.zeros((8, 2 * m)), noise=u)
    torch.testing.assert_close(s1.pos, s2.pos, rtol=0, atol=0)
    assert o1.reward.shape == (8, m)
