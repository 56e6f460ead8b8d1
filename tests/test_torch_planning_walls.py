"""Port parity: the four wall rules, ``seg_intersect`` and ``quat_to_R2``.

The port's plain rules (``ops/kernels/walls.py``, the kernels' table walk
written in PyTorch) must equal the JAX package's trace-time rules
(``pallas_step._make_wall_valid*``) and its dense rule
(``ops/walls.qpos_is_valid``) flag for flag on fuzzed poses.

One difference is allowed by construction and never met by these fuzz
points: on holed layouts the Pallas rule compares against NumPy float64
edges, which under the suite's x64 mode compare in float64, while the chip
(and the port) compare against their f32 roundings; the two differ only for
a coordinate exactly equal to a rounded edge
(``test_rounding_tie_edge_follows_f32`` pins one such point).
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu.ops import walls as jwalls
from gymnasium_planar_robotics_tpu.ops.grid import make_tile_grid as jax_make_tile_grid
from gymnasium_planar_robotics_tpu_torch.ops.kernels import walls

LAYOUTS = {
    'full3x3': np.ones((3, 3)),
    'full1x4': np.ones((1, 4)),
    'holed': np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]]),
    'ring': np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]]),
    'lshape': np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]]),
    'odd4x5': np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 1], [0, 1, 1, 1, 1], [1, 1, 0, 1, 1]]),
}
N = 4096


def _setup(name):
    layout = LAYOUTS[name]
    jgrid = jax_make_tile_grid(layout, np.array([0.12, 0.12, 0.0176]), dtype=jnp.float32)
    g = pallas_step._grid_np(SimpleNamespace(grid=jgrid))
    rule = walls.make_wall_rule(walls.grid_np(SimpleNamespace(grid=jgrid)))
    assert rule.full == bool(layout.all())
    rng = np.random.default_rng(sum(map(ord, name)))
    # positions spanning past the table edges on all sides
    px = rng.uniform(-0.3, layout.shape[0] * 0.24 + 0.3, N).astype(np.float32)
    py = rng.uniform(-0.3, layout.shape[1] * 0.24 + 0.3, N).astype(np.float32)
    return jgrid, g, rule, rng, px, py


@pytest.mark.parametrize('name', sorted(LAYOUTS))
def test_circle_rule_matches_jax_exactly(name):
    jgrid, g, rule, _, px, py = _setup(name)
    jfn = pallas_step._make_wall_valid(g)
    tx, ty = torch.from_numpy(px), torch.from_numpy(py)
    for c in (0.01, 0.055, 0.11):
        want = np.asarray(jfn(jnp.asarray(px), jnp.asarray(py), c))
        got = walls.shape_valid(rule, False, tx, ty, walls.IDENTITY_R, walls.f32(c), walls.f32(c)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f'circle c={c}')
        dense = np.asarray(jwalls.qpos_is_valid(jgrid, jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1),
                                                jnp.full((N,), c, jnp.float32)))
        np.testing.assert_array_equal(got, dense, err_msg=f'dense circle c={c}')
        assert 0 < got.sum() < N


@pytest.mark.parametrize('name', ['full3x3', 'full1x4', 'lshape'])
def test_box_rule_matches_jax_exactly(name):
    jgrid, g, rule, rng, px, py = _setup(name)
    jfn = pallas_step._make_wall_valid_box(g)
    q = (rng.normal(size=(4, N)) * 0.05).astype(np.float32)
    qw = (1.0 + q[0]).astype(np.float32)
    jR = pallas_step._quat_to_R2(jnp.asarray(qw), *(jnp.asarray(x) for x in q[1:]))
    tR = walls.quat_to_R2(torch.from_numpy(qw), *(torch.from_numpy(x) for x in q[1:]))
    for a, b in zip(tR, jR):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tx, ty = torch.from_numpy(px), torch.from_numpy(py)
    n_valid = 0
    for chx, chy in ((0.09, 0.09), (0.12, 0.06)):
        want = np.asarray(jfn(jnp.asarray(px), jnp.asarray(py), *jR, chx, chy))
        got = walls.shape_valid(rule, True, tx, ty, tR, walls.f32(chx), walls.f32(chy)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f'box {chx}x{chy}')
        # the dense rule at the identity orientation (the reset-time check)
        want_id = np.asarray(jfn(jnp.asarray(px), jnp.asarray(py), 1.0, 0.0, 0.0, 1.0, chx, chy))
        got_id = walls.sample_valid_at(rule, True, tx, ty, (walls.f32(chx), walls.f32(chy))).numpy()
        np.testing.assert_array_equal(got_id, want_id, err_msg=f'box identity {chx}x{chy}')
        quat = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, 0.0]], jnp.float32), (N, 1))
        dense = np.asarray(jwalls.qpos_is_valid(
            jgrid, jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1),
            jnp.tile(jnp.asarray([[chx, chy]], jnp.float32), (N, 1)), quat=quat, collision_shape='box'))
        np.testing.assert_array_equal(got_id, dense, err_msg=f'dense box {chx}x{chy}')
        n_valid += int(got.sum())
    assert 0 < n_valid < 2 * N


def test_missing_corner_tests_fire():
    """On the L-shape the corner rectangle test decides some poses: the
    rule without it accepts poses the full rule rejects."""
    _, _, rule, _, _, _ = _setup('lshape')
    assert sum(len(c.corners) for c in rule.cells) == 2
    no_corners = walls.WallRule(full=False, rect={}, cells=tuple(
        walls.Cell(edges=c.edges, flags=c.flags, corners=()) for c in rule.cells), table=rule.table)
    rng = np.random.default_rng(1)
    px = torch.from_numpy(rng.uniform(0.3, 0.42, N).astype(np.float32))
    py = torch.from_numpy(rng.uniform(0.3, 0.42, N).astype(np.float32))
    R = walls.quat_to_R2(*(torch.from_numpy(x.astype(np.float32)) for x in
                           (1.0 + rng.normal(size=N) * 0.3, *(rng.normal(size=(3, N)) * 0.3))))
    with_c = walls.shape_valid(rule, True, px, py, R, 0.1, 0.1)
    without = walls.shape_valid(no_corners, True, px, py, R, 0.1, 0.1)
    assert bool((without & ~with_c).any()) and not bool((with_c & ~without).any())


def test_rounding_tie_edge_follows_f32():
    """Tile (0, 1)'s lower edge is 0.36f - 0.12f = 0.24000001698732376 in
    float64, a tie between two f32 values that rounds to
    0.24000000953674316; tile (0, 0)'s upper edge is 2 * 0.12f =
    0.23999999463558197.  A centre at y = 0.24000000953674316 lies on tile
    (0, 1)'s f32 edge, so the chip and the port call a small circle there
    valid (it is rescued by tile (0, 0) below it).  Compared against the
    float64 edges (the JAX rule under x64) the centre covers neither tile
    and is invalid; with x64 off the JAX rule agrees with the port."""
    jgrid, g, rule, _, _, _ = _setup('holed')
    px = np.array([0.12], np.float32)
    py = np.array([np.float32(0.36) - np.float32(0.12)], np.float32)
    assert float(py[0]) == 0.24000000953674316
    assert float(g['tile_y'][0, 1]) - g['tsy'] == 0.24000001698732376
    c = 0.05
    got = walls.shape_valid(rule, False, torch.from_numpy(px), torch.from_numpy(py), walls.IDENTITY_R,
                            walls.f32(c), walls.f32(c))
    assert got.tolist() == [True]
    jfn = pallas_step._make_wall_valid(g)
    assert np.asarray(jfn(jnp.asarray(px), jnp.asarray(py), c)).tolist() == [False]
    with jax.enable_x64(False):
        assert np.asarray(jfn(jnp.asarray(px), jnp.asarray(py), c)).tolist() == [True]


def test_seg_intersect_matches_jax_exactly():
    """Random segments on a coarse lattice (shared endpoints, collinear and
    touching cases are frequent) and in general position."""
    rng = np.random.default_rng(7)
    n = 20000
    pts = [rng.integers(0, 4, (8, n)).astype(np.float32) * 0.1, rng.uniform(0, 1, (8, n)).astype(np.float32)]
    for p in pts:
        want = np.asarray(pallas_step._seg_intersect(*(jnp.asarray(x) for x in p)))
        got = walls.seg_intersect(*(torch.from_numpy(x) for x in p)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < n
