"""Port parity: the dense wall rule ``ops/walls.qpos_is_valid`` against the
JAX package's, boolean for boolean, and the resets' wall decisions.

Full, holed and L-shaped layouts, circle and box, float32 and float64;
positions cover the table and a margin beyond it, sizes reach past the
tile's half-size (0.12).  Both packages evaluate the same comparisons in
the same dtype, so every boolean must be equal (random positions keep
clear of exact ties).  The oversized case r = 0.147 at x = 0.1 on the 4x4
table is where the dense rule (the resets') and the kernels' closed form
part: both packages' resets now take the dense rule there.
"""

import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import common as jcommon
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu.ops import walls as jwalls
from gymnasium_planar_robotics_tpu.ops.grid import make_tile_grid as jgrid
from gymnasium_planar_robotics_tpu_torch.models import common
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import walls
from gymnasium_planar_robotics_tpu_torch.ops.grid import make_tile_grid
from gymnasium_planar_robotics_tpu_torch.ops.kernels import walls as kwalls

LAYOUTS = {
    'full': np.ones((3, 3)),
    'holed': np.array([[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 1], [1, 1, 1, 1]]),
    'lshape': np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]]),
}


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('shape', ['circle', 'box'])
@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_qpos_is_valid_matches_jax(layout, shape, dtype):
    rng = np.random.default_rng(zlib.crc32(f'{layout}/{shape}/{dtype}'.encode()))
    lay = LAYOUTS[layout]
    q = 600
    extent = 0.24 * np.array(lay.shape)
    xy = rng.uniform(-0.05, extent + 0.05, (q, 2)).astype(dtype)
    if shape == 'circle':
        c = rng.uniform(0.05, 0.16, q).astype(dtype)
        quat = None
    else:
        c = rng.uniform(0.04, 0.14, (q, 2)).astype(dtype)
        quat = (np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, 0.2, (q, 4)) * (rng.random((q, 1)) < 0.5))
        quat = quat.astype(dtype)
    jg = jgrid(lay, dtype=jnp.dtype(dtype))
    tg = make_tile_grid(lay, dtype=getattr(torch, dtype), device='cpu')
    want = np.asarray(jwalls.qpos_is_valid(jg, jnp.asarray(xy), jnp.asarray(c),
                                           quat=None if quat is None else jnp.asarray(quat), collision_shape=shape))
    got = walls.qpos_is_valid(tg, torch.from_numpy(xy), torch.from_numpy(c),
                              quat=None if quat is None else torch.from_numpy(quat), collision_shape=shape).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9, want.mean()  # both outcomes are exercised


def test_wall_collision_any_over_movers_matches_jax():
    """``common.wall_collision_any`` over ``[B, M, 2]`` (per-mover sizes)
    against the JAX function vmapped over the batch."""
    rng = np.random.default_rng(5)
    lay = LAYOUTS['holed']
    b, m = 300, 3
    xy = rng.uniform(0.0, 0.96, (b, m, 2)).astype(np.float32)
    c = np.array([0.11, 0.14, 0.12], np.float32)
    jg = jgrid(lay, dtype=jnp.float32)
    want = np.asarray(jax.vmap(lambda p: jcommon.wall_collision_any(jg, p, None, jnp.asarray(c), 'circle'))(
        jnp.asarray(xy)))
    got = common.wall_collision_any(make_tile_grid(lay, dtype=torch.float32, device='cpu'), torch.from_numpy(xy),
                                    None, torch.from_numpy(c), 'circle').numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < b


def test_oversized_circle_resets_agree_with_jax():
    """r = 0.147 at x = 0.1 on the 4x4 table: the dense rule accepts, the
    kernels' closed form rejects.  The port's planning reset (given starts)
    and pushing reset's wall flag follow the dense rule, as JAX's do."""
    lay = np.ones((4, 4))
    xy = np.array([[0.1, 0.5]], np.float32)
    tg = make_tile_grid(lay, dtype=torch.float32, device='cpu')
    c = torch.tensor([0.147])
    dense = ~common.wall_collision_any(tg, torch.from_numpy(xy)[None], None, c, 'circle')
    rule = kwalls.make_wall_rule(kwalls.grid_np(tplan.make_planning_env(lay, 1, device='cpu')[1]))
    x, y = torch.from_numpy(xy).unbind(-1)
    kernel_rule = kwalls.shape_valid(rule, False, x, y, kwalls.IDENTITY_R, 0.147, 0.147)
    assert bool(dense.all()) and not bool(kernel_rule.any())

    coll = {'size': 0.147}
    jcfg, jprm = jplan.make_planning_env(lay, 1, collision_params=coll, std_noise=0.0, dtype=jnp.float32)
    tcfg, tprm = tplan.make_planning_env(lay, 1, collision_params=coll, std_noise=0.0, device='cpu')
    starts = np.array([[[0.1, 0.5]], [[0.1, 0.1]], [[0.5, 0.5]], [[0.05, 0.5]]], np.float32)
    goals = np.full_like(starts, 0.48)
    _, _, ji = jax.vmap(lambda k, s, g: jplan.reset(jcfg, jprm, k, start_xy=s, goals_xy=g))(
        jax.random.split(jax.random.PRNGKey(0), len(starts)), jnp.asarray(starts), jnp.asarray(goals))
    _, _, ti = tplan.reset(tcfg, tprm, len(starts), torch.Generator().manual_seed(0),
                           start_xy=torch.from_numpy(starts), goals_xy=torch.from_numpy(goals))
    for k in ('wall_collision', 'reset_stalled'):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    assert not ti['wall_collision'][0] and not ti['reset_stalled'][0]
    assert ti['wall_collision'].any()

    # pushing on its 3x3 table: the reset's wall flag at the start pose
    jcfg, jprm = jpush.make_pushing_env(collision_params=coll, std_noise=0.0, dtype=jnp.float32)
    tcfg, tprm = tpush.make_pushing_env(collision_params=coll, std_noise=0.0, device='cpu')
    for start in ([0.1, 0.3], [0.05, 0.3], [0.3, 0.3]):
        _, _, ji = jpush.reset(jcfg, jprm, jax.random.PRNGKey(1), mover_start_xy_pos=jnp.asarray(start, jnp.float32))
        _, _, ti = tpush.reset(tcfg, tprm, 1, torch.Generator().manual_seed(0), mover_start_xy_pos=start)
        assert bool(ti['wall_collision'][0]) == bool(ji['wall_collision']), start
