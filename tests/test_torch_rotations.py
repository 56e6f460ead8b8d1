"""Port parity: ``ops/rotations.py``, every function against the JAX
package's on the same random float64 inputs (batched over two leading
dimensions), atol 1e-12; ``mat2quat`` up to the quaternion's sign, as
``tests/test_rotations.py`` allows.  The port keeps float64 where given it."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.ops import rotations as jrot
from gymnasium_planar_robotics_tpu_torch.ops import rotations as trot

ATOL = 1e-12
SHAPE = (7, 5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(rng, shape=SHAPE):
    q = rng.normal(size=(*shape, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _eulers(rng, shape=SHAPE):
    return rng.uniform(-np.pi, np.pi, (*shape, 3))


def _close(got, want, atol=ATOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


def _both(name, *args):
    return (getattr(trot, name)(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args)),
            getattr(jrot, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)))


@pytest.mark.parametrize('name', ['euler2mat', 'euler2quat', 'euler2point_euler', 'normalize_angles',
                                  'round_to_straight_angles'])
def test_functions_of_euler_angles(name):
    e = _eulers(_rng(1))
    if name in ('normalize_angles', 'round_to_straight_angles'):
        e = e * 3.0  # beyond [-pi, pi]
    _close(*_both(name, e))


@pytest.mark.parametrize('name', ['quat2mat', 'quat2euler', 'quat_conjugate', 'quat2axisangle', 'quat2point_quat'])
def test_functions_of_quaternions(name):
    q = _quats(_rng(2))
    q[0, 0] = [1.0, 0.0, 0.0, 0.0]  # identity: the small-angle branch
    q[0, 1] = [-0.6, 0.0, 0.8, 0.0]  # w < 0
    _close(*_both(name, q))


def test_quat2mat_near_zero_is_identity():
    q = np.zeros((3, 4))
    q[1] = [1e-9, 0, 0, 0]
    _close(*_both('quat2mat', q))


def test_mat2euler_and_subtract_euler():
    rng = _rng(3)
    m = np.array(jrot.euler2mat(jnp.asarray(_eulers(rng))))
    m[0, 0] = np.asarray(jrot.euler2mat(jnp.asarray([0.3, np.pi / 2, -0.2])))  # gimbal lock
    _close(*_both('mat2euler', m))
    _close(*_both('subtract_euler', _eulers(rng), _eulers(rng)))


def test_mat2quat_up_to_sign():
    rng = _rng(4)
    q = _quats(rng)
    q[0, 0] = [0.0, 1.0, 0.0, 0.0]  # each candidate of the selection leads somewhere
    q[0, 1] = [0.0, 0.0, 1.0, 0.0]
    q[0, 2] = [0.0, 0.0, 0.0, 1.0]
    m = np.array(jrot.quat2mat(jnp.asarray(q)))
    got, want = trot.mat2quat(torch.as_tensor(m)).numpy(), np.asarray(jrot.mat2quat(jnp.asarray(m)))
    err = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
    assert err.max() <= ATOL
    assert (got[..., 0] >= 0).all()


def test_quat_products_and_rotation():
    rng = _rng(5)
    q0, q1, v = _quats(rng), _quats(rng), rng.normal(size=(*SHAPE, 3))
    _close(*_both('quat_mul', q0, q1))
    _close(*_both('quat_rot_vec', q0, v))
    _close(*_both('quat_rot_vec', q0[0, 0], v))  # one quaternion, many vectors
    _close(*_both('unit_vector', rng.normal(size=(*SHAPE, 4))))
    assert torch.equal(trot.quat_identity(torch.float64), torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64))


def test_quat_slerp_with_degenerate_cases():
    rng = _rng(6)
    q0, q1 = _quats(rng), _quats(rng)
    frac = rng.uniform(0, 1, SHAPE)
    frac[0, 0], frac[0, 1] = 0.0, 1.0
    q1[1, 0] = q0[1, 0]  # parallel
    q1[1, 1] = -q0[1, 1]  # antipodal: the shortest path flips it
    for short in (True, False):
        _close(trot.quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(frac), short),
               jrot.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(frac), short))


def test_point_forms_round_trip():
    rng = _rng(7)
    pe = np.asarray(jrot.euler2point_euler(jnp.asarray(_eulers(rng))))
    _close(*_both('point_euler2euler', pe))
    q = _quats(rng)
    q[..., 0] = np.abs(q[..., 0])
    pq = np.asarray(jrot.quat2point_quat(jnp.asarray(q)))
    _close(*_both('point_quat2quat', pq))


def test_parallel_rotations():
    got, want = trot.get_parallel_rotations(), jrot.get_parallel_rotations()
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
