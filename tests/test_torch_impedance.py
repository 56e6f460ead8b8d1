"""Port parity: ``utils/impedance.py`` against the JAX package's on the
cases of ``tests/test_utils.py:136-176`` (the critical-damping rule, the
restoring wrench with masked DoFs, the orientation error's direction) and on
random batched poses, float64, atol 1e-12; ``ctrl_callback`` applied as the
JAX package applies it; the lazy names of the package root."""

import numpy as np

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.utils import impedance as jimp
from gymnasium_planar_robotics_tpu_torch.utils import impedance as timp

ATOL = 1e-12


def _gains(*args, **kw):
    return timp.make_gains(*args, device='cpu', **kw), jimp.make_gains(*args, **kw)


def _check_gains(t, j):
    for f in ('stiffness', 'damping', 'joint_mask'):
        got = getattr(t, f)
        assert got.dtype == torch.float64 and got.shape == (6,)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j, f)), rtol=0, atol=ATOL, err_msg=f)


def _wrench(gains, *arrays, ctrl_callback=None, jax_callback=None):
    tg, jg = gains
    got = timp.impedance_wrench(tg, *(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays),
                                ctrl_callback=ctrl_callback)
    want = jimp.impedance_wrench(jg, *(jnp.asarray(np.asarray(a, np.float64)) for a in arrays),
                                 ctrl_callback=jax_callback)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    return got.numpy()


def test_critical_damping_rule():
    g = _gains(1.24, translational_stiffness=1.0, rotational_stiffness=0.1)
    _check_gains(*g)
    np.testing.assert_allclose(g[0].damping[:3].numpy(), 2 * np.sqrt(1.24))
    np.testing.assert_allclose(g[0].damping[3:].numpy(), 2 * np.sqrt(0.1 * 1.24))


def test_restoring_wrench_with_masked_dofs():
    g = _gains(1.0, 2.0, 0.5, joint_mask=np.array([0, 0, 1, 1, 1, 1]))
    _check_gains(*g)
    quat = [1.0, 0.0, 0.0, 0.0]
    w = _wrench(g, [0.1, 0.2, 0.05], quat, np.zeros(6), [0.0, 0.0, 0.009], quat)
    assert w[0] == 0 and w[1] == 0 and w[2] < 0
    np.testing.assert_allclose(w[3:], 0, atol=1e-12)


def test_orientation_error_direction():
    g = _gains(1.0, 1.0, 1.0)
    ang = 0.3
    w = _wrench(g, np.zeros(3), [1.0, 0.0, 0.0, 0.0], np.zeros(6), np.zeros(3),
                [np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)])
    np.testing.assert_allclose(w[5], ang, atol=1e-9)
    np.testing.assert_allclose(w[:5], 0, atol=1e-9)


def test_random_batched_poses_and_callback():
    rng = np.random.default_rng(0)
    n = (6, 50)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    arrays = (rng.normal(0, 0.1, (*n, 3)), unit(rng.normal(size=(*n, 4))), rng.normal(0, 0.2, (*n, 6)),
              rng.normal(0, 0.1, (*n, 3)), unit(rng.normal(size=(*n, 4))))
    g = _gains(1.24, [1.0, 2.0, 3.0], 0.5, joint_mask=[1, 1, 0, 1, 1, 1])
    w = _wrench(g, *arrays)
    limit = 0.5 * np.abs(w).max()
    clipped = _wrench(g, *arrays, ctrl_callback=lambda c: torch.clamp(c, -limit, limit),
                      jax_callback=lambda c: jnp.clip(c, -limit, limit))
    assert np.abs(clipped).max() <= limit and (clipped != w).any()


def test_lazy_names_of_the_package():
    import gymnasium_planar_robotics_tpu_torch as pkg
    from gymnasium_planar_robotics_tpu_torch import core

    assert pkg.ImpedanceGains is timp.ImpedanceGains and pkg.make_gains is timp.make_gains
    assert pkg.impedance_wrench is timp.impedance_wrench
    assert pkg.BasicPlanarRoboticsEnv is core.PlanarRoboticsCore
