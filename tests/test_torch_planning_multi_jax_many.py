"""Kernel H above 64 movers against the JAX package, on the CPU.

The JAX package's Pallas kernel H does not trace in interpret mode within a
test's time at 65 movers (it unrolls the M(M-1)/2 pairs), but its eager
``models/planning.step`` tests the pairs as one vectorised program
(``models/common.py``), jitted and vmapped over the envs in seconds.  So the
port's fused autoreset step (kernel H's plain version: the L = 4 slots at 65
movers, the many-mover variant at 129) is held here against that eager step
at ``std_noise=0``, box movers (never held against the JAX package above 64
movers before) and circles on the ladder of slots
(``tests/torch_planning_multi_cases.py``), 8 envs, 4 control cycles, with
mover 0 driven into the -x wall in two envs and movers 0 and 1 head-on in
two.  On the envs that do not restart: wall and mover flags equal, positions
and velocities to rtol 2e-6 / atol 2e-7, accelerations to rtol 1e-4 / atol
1e-4 (the eager-vs-fused tolerances of ``test_torch_planning_multi_many.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti
from torch_planning_multi_cases import case, make_env, planted_state

PLAN = dict(rtol=2e-6, atol=2e-7)
ACC = dict(rtol=1e-4, atol=1e-4)
B, CYCLES = 8, 4


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize('shape', ['box', 'circle'])
@pytest.mark.parametrize('m, layout', [(65, (32, 4)), (129, (32, kmulti.SMEM_SLOTS))], ids=['m65', 'm129'])
def test_fused_step_above_64_movers_matches_jax_eager_step(m, layout, shape):
    name = f'ladder_m{m}_{shape}_full'
    lay, _, coll, jerk, _, _ = case(name)
    cfg, prm = make_env(name, std_noise=0.0, num_cycles=CYCLES)
    assert cfg.collision_shape == shape and kmulti.lane_layout(m, B) == layout
    jcfg, jprm = jplan.make_planning_env(lay, m, dtype=jnp.float32, collision_params=coll, learn_jerk=jerk,
                                         std_noise=0.0, num_cycles=CYCLES)
    state = planted_state(name, cfg, prm, B, seed=m)
    state.steps[:] = 0
    act = np.random.default_rng(m + 1).uniform(-8.0, 8.0, (B, m, 2)).astype(np.float32)

    d = tplan.state_to_numpy(state)
    jstate = jplan.PlanningState(**{k: jnp.asarray(v) for k, v in d.items()},
                                 key=jax.random.split(jax.random.PRNGKey(m), B))
    js, _, _, _, _, ji = jax.jit(jax.vmap(lambda s, a: jplan.step(jcfg, jprm, s, a)))(jstate, jnp.asarray(act))
    fs, _, _, ft, ftr, fi = tplan.make_fused_step_autoreset(cfg, prm)(state, torch.from_numpy(act),
                                                                       generator=torch.Generator().manual_seed(m))
    for k in ('wall_collision', 'mover_collision'):
        np.testing.assert_array_equal(fi[k].numpy(), np.asarray(ji[k]), err_msg=k)
    rows = ~(ft | ftr).numpy()  # the others restarted in the fused step
    for k in ('pos', 'vel'):
        np.testing.assert_allclose(getattr(fs, k).numpy()[rows], np.asarray(getattr(js, k))[rows], **PLAN, err_msg=k)
    np.testing.assert_allclose(fs.acc.numpy()[rows], np.asarray(js.acc)[rows], **ACC, err_msg='acc')
    assert int(fi['wall_collision'].sum()) >= 1 and int(fi['mover_collision'].sum()) >= 1 and int(rows.sum()) >= 3
