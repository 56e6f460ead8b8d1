"""Port parity: ``ops/rotations``, ``ops/geometry`` and ``ops/collision``
against the JAX package's functions, on random and near-touching poses.

Booleans must be equal; vertices and rotation matrices agree to ulp level
(rtol 1e-6 / atol 1e-7: the sums of the normalisation and of the 3x3
product may round in another order than XLA's).  Near-touching poses keep
their gap (1e-5 and more) outside the segment test's 1e-7 epsilon band, so
both packages must decide them alike.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.ops import collision as jcol
from gymnasium_planar_robotics_tpu.ops import geometry as jgeo
from gymnasium_planar_robotics_tpu.ops import rotations as jrot
from gymnasium_planar_robotics_tpu_torch.ops import collision, geometry, rotations

TOL = dict(rtol=1e-6, atol=1e-7)


def random_quats(rng, n, std):
    """Identity plus normal noise of ``std`` (the engine's noisy poses), or
    uniformly random orientations about z when ``std`` is None."""
    if std is None:
        yaw = rng.uniform(-np.pi, np.pi, n)
        return np.stack([np.cos(yaw / 2), np.zeros(n), np.zeros(n), np.sin(yaw / 2)], -1).astype(np.float32)
    return (np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0.0, std, (n, 4))).astype(np.float32)


@pytest.mark.parametrize('std', [1e-5, 0.3, None], ids=['noisy_identity', 'large_noise', 'random_yaw'])
def test_rotations_match_jax(std):
    rng = np.random.default_rng(0)
    q = random_quats(rng, 500, std) * rng.uniform(0.5, 2.0, (500, 1)).astype(np.float32)
    q[0] = 0.0  # the near-zero guard returns the identity
    unit = rotations.unit_vector(torch.from_numpy(q[1:]))
    np.testing.assert_allclose(unit.numpy(), np.asarray(jrot.unit_vector(jnp.asarray(q[1:]))), **TOL)
    got = rotations.quat2mat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrot.quat2mat(jnp.asarray(q))), **TOL)
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))


def near_touching_boxes(rng, n, ha, hb, quat_std):
    """Box pairs whose centres sit at the summed half-extents along x or y,
    plus a gap of +-(1e-5 ... 1e-2), and a random offset along the other
    axis; orientations the identity plus noise."""
    ca = rng.uniform(0.2, 0.5, (n, 2))
    axis = rng.integers(0, 2, n)
    gap = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-5, -2, n)
    sep = np.where(axis == 0, ha[0] + hb[0], ha[1] + hb[1]) + gap
    side = rng.uniform(-0.15, 0.15, n)
    off = np.where(axis[:, None] == 0, np.stack([sep, side], -1), np.stack([side, sep], -1))
    qa, qb = random_quats(rng, n, quat_std), random_quats(rng, n, quat_std)
    qpa = np.concatenate([ca, np.zeros((n, 1)), qa], -1).astype(np.float32)
    qpb = np.concatenate([ca + off, np.zeros((n, 1)), qb], -1).astype(np.float32)
    return qpa, qpb


@pytest.mark.parametrize('quat_std', [0.0, 1e-5], ids=['identity', 'noisy'])
def test_rectangles_intersect_matches_jax(quat_std):
    rng = np.random.default_rng(1)
    n = 4000
    ha, hb = np.array([0.09, 0.08]), np.array([0.07, 0.09])
    qpa, qpb = near_touching_boxes(rng, n, ha, hb, quat_std)
    sa = np.tile(ha, (n, 1)).astype(np.float32)
    sb = np.tile(hb, (n, 1)).astype(np.float32)
    want = np.asarray(jgeo.check_rectangles_intersect(jnp.asarray(qpa), jnp.asarray(qpb), jnp.asarray(sa),
                                                      jnp.asarray(sb)))
    got = geometry.check_rectangles_intersect(*(torch.from_numpy(x) for x in (qpa, qpb, sa, sb))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.3 < want.mean() < 0.7  # the poses straddle contact
    verts = geometry.get_2D_rect_vertices(torch.from_numpy(qpa), torch.from_numpy(sa)).numpy()
    np.testing.assert_allclose(verts, np.asarray(jgeo.get_2D_rect_vertices(jnp.asarray(qpa), jnp.asarray(sa))),
                               **TOL)
    # containment: a box strictly inside another is no intersection in either
    qp = torch.tensor([[0.4, 0.4, 0.0, 1.0, 0.0, 0.0, 0.0]])
    assert not bool(geometry.check_rectangles_intersect(qp, qp, torch.tensor([[0.01, 0.01]]),
                                                        torch.tensor([[0.09, 0.09]]))[0])


def test_segments_match_jax():
    """Random segments, collinear overlaps, shared endpoints and gaps at the
    epsilon's scale."""
    rng = np.random.default_rng(2)
    n = 3000
    p1, p2, q1, q2 = (rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32) for _ in range(4))
    k = n // 3
    q1[:k] = p2[:k]  # shared endpoints
    t = rng.uniform(0.2, 0.8, (k, 1)).astype(np.float32)
    q1[k:2 * k] = p1[k:2 * k] + t * (p2[k:2 * k] - p1[k:2 * k])  # collinear, overlapping
    q2[k:2 * k] = p2[k:2 * k] + t * (p2[k:2 * k] - p1[k:2 * k])
    want = np.asarray(jgeo.check_line_segments_intersect(*(jnp.asarray(x) for x in (p1, p2, q1, q2))))
    got = geometry.check_line_segments_intersect(*(torch.from_numpy(x) for x in (p1, p2, q1, q2))).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[:k].all() and 0.05 < want[2 * k:].mean() < 0.95


@pytest.mark.parametrize('shape', ['circle', 'box'])
def test_mover_collision_matches_jax(shape):
    """M = 4 movers, per-mover sizes, pairs near touching and apart."""
    rng = np.random.default_rng(3)
    b, m = 2000, 4
    if shape == 'circle':
        c = np.array([0.11, 0.14, 0.10, 0.12], np.float32)
        reach = c[0] + c[1]
    else:
        c = np.array([[0.09, 0.08], [0.07, 0.09], [0.08, 0.08], [0.09, 0.07]], np.float32)
        reach = c[0, 0] + c[1, 0]
    xy = (np.array([[0.2, 0.2], [0.2, 0.2], [0.75, 0.2], [0.2, 0.75]]) + rng.normal(0, 0.01, (b, m, 2)))
    # movers 0 and 1 along x at the summed sizes, +-(1e-5 ... 1e-2)
    gap = rng.choice([-1.0, 1.0], b) * 10.0 ** rng.uniform(-5, -2, b)
    xy[:, 1] = xy[:, 0] + np.stack([reach + gap, np.zeros(b)], -1)
    xy = xy.astype(np.float32)
    quat = np.stack([random_quats(rng, b, 1e-5) for _ in range(m)], 1) if shape == 'box' else np.zeros((b, m, 4))
    want = np.asarray(jax.jit(jax.vmap(lambda x, q: jcol.check_mover_collision(
        x, jnp.asarray(c), quat=q if shape == 'box' else None, collision_shape=shape)))(
            jnp.asarray(xy), jnp.asarray(quat, jnp.float32)))
    got = collision.check_mover_collision(torch.from_numpy(xy), torch.from_numpy(c),
                                          quat=torch.from_numpy(quat) if shape == 'box' else None,
                                          collision_shape=shape).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.3 < got.mean() < 0.7
    assert not collision.check_mover_collision(torch.zeros((3, 1, 2)), torch.tensor([0.1])).any()
