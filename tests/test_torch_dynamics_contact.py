"""Port parity: ``ops/dynamics`` and ``ops/contact`` against the JAX
package's, in float32 and float64, on random batched inputs that reach every
branch (clamped and free, in contact and apart, sticky axis on either face,
slip inside and beyond the cone's band).

Tolerances: rtol 2e-6 / atol 1e-8 in float32 and rtol 1e-12 / atol 1e-15 in
float64 (the same operations in the same order; XLA contracts some
multiply-adds into FMAs, so a difference of two products such as the
contact torque may differ by an ulp of its terms, ~1e-8 at 0.1); boolean
outputs equal.  The derivative back-computed from a clamp, ``(v' - v) /
dt``, scales an ulp of ``v'`` (2.4e-7 at |v| = 2) by 1 / dt = 1000: atol
5e-4 in float32, 1e-12 in float64, there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.ops import contact as jcontact
from gymnasium_planar_robotics_tpu.ops import dynamics as jdyn
from gymnasium_planar_robotics_tpu_torch.ops import contact, dynamics

DTYPES = ['float32', 'float64']


def tol(dtype, deriv=False):
    if dtype == 'float64':
        return dict(rtol=1e-12, atol=1e-12 if deriv else 1e-15)
    return dict(rtol=2e-6, atol=5e-4 if deriv else 1e-8)


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('dtype', DTYPES)
def test_dynamics_match_jax(dtype):
    rng = np.random.default_rng(0)
    b = 400
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(dtype)  # noqa: E731
    pos, vel, act = f(b, 3, 2, scale=0.3), f(b, 3, 2, scale=1.2), f(b, 3, 2, scale=6.0)
    vel_meas = vel + f(b, 3, 2, scale=1e-3)
    action = f(b, 3, 2, scale=60.0)
    scale = np.array([[1.0], [0.8125], [0.9]], dtype)
    v_max, a_max, dt = np.asarray(2.0, dtype), np.asarray(10.0, dtype), np.asarray(0.001, dtype)

    jv, tv = both(vel_meas)
    ja, ta = both(action * 0.1)
    for (jo, to), d in zip(zip(jdyn.ensure_max_dyn_val(jv, jnp.asarray(v_max), ja, jnp.asarray(dt)),
                               dynamics.ensure_max_dyn_val(tv, torch.from_numpy(v_max), ta, torch.from_numpy(dt))),
                           (False, True)):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol(dtype, d))

    jargs = [jnp.asarray(x) for x in (pos, vel, vel_meas, action * 0.2, v_max, dt, scale)]
    targs = [torch.from_numpy(np.asarray(x)) for x in (pos, vel, vel_meas, action * 0.2, v_max, dt, scale)]
    jr, tr = jdyn.acceleration_cycle(*jargs), dynamics.acceleration_cycle(*targs)
    for name in jr._fields:
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), **tol(dtype, True),
                                   err_msg=name)
    jargs = [jnp.asarray(x) for x in (pos, vel, act, vel_meas, action, v_max, a_max, dt, scale)]
    targs = [torch.from_numpy(np.asarray(x)) for x in (pos, vel, act, vel_meas, action, v_max, a_max, dt, scale)]
    jr, tr = jdyn.jerk_cycle(*jargs), dynamics.jerk_cycle(*targs)
    for name in jr._fields:
        np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), **tol(dtype, True),
                                   err_msg=name)
    # both clamps fire on some envs and not on others
    speed = np.linalg.norm(vel_meas + 0.001 * action * 0.2, axis=-1)
    assert (speed >= 2.0).any() and (speed < 2.0).any()


def _contact_inputs(dtype, b=600, seed=1):
    rng = np.random.default_rng(seed)
    mover = rng.uniform(0.2, 0.5, (b, 2))
    # object placed around the mover's faces and corners: in contact or not
    ang = rng.uniform(-np.pi, np.pi, b)
    dist = rng.uniform(0.08, 0.13, b)
    obj = mover + np.stack([np.cos(ang), np.sin(ang)], -1) * dist[:, None]
    obj[:20] = mover[:20] + [0.1, 0.0]  # d_y == 0: the sign's tie
    vals = dict(
        mover_xy=mover, mover_vel=rng.normal(0, 0.4, (b, 2)), obj_xy=obj, obj_vel=rng.normal(0, 0.4, (b, 2)),
        obj_yaw=rng.normal(0, 0.05, b), obj_w=rng.normal(0, 2.0, b), sticky=rng.integers(-1, 2, b).astype(float),
        z=rng.uniform(0.0, 0.01, b),
    )
    return {k: v.astype(dtype) for k, v in vals.items()}


@pytest.mark.parametrize('dtype', DTYPES)
def test_box_push_contact_v2_matches_jax(dtype):
    v = _contact_inputs(dtype)
    c = lambda x: np.asarray(x, dtype)  # noqa: E731
    consts = dict(mover_half=c([0.0775, 0.0775]), obj_half=c([0.035, 0.035]), k_n=c(30.0), b_n=c(1.0954451),
                  b_t=c(1.0), mu=c(0.8))
    cone = dict(cone_zeta=c(0.8), cone_vt=c(0.25), cone_vt_hi=c(0.4), cone_vt_off=c(0.7))
    fz_cap = c(0.008) + c(100.0) * v['z']
    order = ('mover_xy', 'mover_vel', 'obj_xy', 'obj_vel', 'obj_yaw', 'obj_w')
    jout = jcontact.box_push_contact_v2(*[jnp.asarray(v[k]) for k in order],
                                        *[jnp.asarray(x) for x in consts.values()],
                                        sticky_axis=jnp.asarray(v['sticky']), fz_cap=jnp.asarray(fz_cap),
                                        **{k: jnp.asarray(x) for k, x in cone.items()})
    tout = contact.box_push_contact_v2(*[torch.from_numpy(v[k]) for k in order],
                                       *[torch.from_numpy(x) for x in consts.values()],
                                       sticky_axis=torch.from_numpy(v['sticky']), fz_cap=torch.from_numpy(fz_cap),
                                       **{k: torch.from_numpy(x) for k, x in cone.items()})
    for name in jout._fields:
        got, want = getattr(tout, name).numpy(), np.asarray(getattr(jout, name))
        if name == 'in_contact':
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **tol(dtype), err_msg=name)
    ic = np.asarray(jout.in_contact)
    assert 0.2 < ic.mean() < 0.9 and (np.asarray(jout.f_z) > 0).any() and (np.asarray(jout.axis) == 1).any()
    # without the carried axis and with the default cone arguments
    jout = jcontact.box_push_contact_v2(*[jnp.asarray(v[k]) for k in order],
                                        *[jnp.asarray(x) for x in consts.values()])
    tout = contact.box_push_contact_v2(*[torch.from_numpy(v[k]) for k in order],
                                       *[torch.from_numpy(x) for x in consts.values()])
    for name in ('f_obj', 'torque_obj', 'axis', 'f_z'):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), **tol(dtype),
                                   err_msg=name)


@pytest.mark.parametrize('dtype', DTYPES)
def test_box_push_contact_and_floor_steps_match_jax(dtype):
    v = _contact_inputs(dtype, seed=2)
    c = lambda x: np.asarray(x, dtype)  # noqa: E731
    consts = [c([0.0775, 0.0775]), c([0.035, 0.035]), c(30.0), c(1.0954451), c(1.0), c(0.8)]
    order = ('mover_xy', 'mover_vel', 'obj_xy', 'obj_vel')
    jout = jcontact.box_push_contact(*[jnp.asarray(v[k]) for k in order], *[jnp.asarray(x) for x in consts])
    tout = contact.box_push_contact(*[torch.from_numpy(v[k]) for k in order], *[torch.from_numpy(x) for x in consts])
    for name in jout._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), **tol(dtype),
                                   err_msg=name)
    # Coulomb floor and spin steps: some stop dead, some keep sliding
    rng = np.random.default_rng(3)
    vel = (rng.normal(0, 0.02, (300, 2)) * (rng.random((300, 1)) < 0.9)).astype(dtype)
    mu_g_dt = (c(9.81e-3) * rng.uniform(1.0, 3.0, (300, 1))).astype(dtype)
    got = contact.coulomb_floor_step(torch.from_numpy(vel), torch.from_numpy(mu_g_dt)).numpy()
    want = np.asarray(jcontact.coulomb_floor_step(jnp.asarray(vel), jnp.asarray(mu_g_dt)))
    np.testing.assert_allclose(got, want, **tol(dtype))
    assert (want == 0).all(-1).any() and (want != 0).any()
    omega = rng.normal(0, 0.1, 300).astype(dtype)
    got = contact.coulomb_spin_step(torch.from_numpy(omega), torch.from_numpy(c(0.06))).numpy()
    np.testing.assert_allclose(got, np.asarray(jcontact.coulomb_spin_step(jnp.asarray(omega), jnp.asarray(c(0.06)))),
                               **tol(dtype))
