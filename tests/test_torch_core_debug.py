"""Port parity: the domain-core facade (``core.py``) and the checked step
(``models/debug.py``) against the JAX package's.

The facade's methods on the cases of ``tests/test_core_facade.py`` (the
holed layout with safety offsets, circle and box, every mask shape of the
pattern search over random layouts), results equal; the checked step on the
scenarios of ``tests/test_debug_mode.py:12-62`` (clean, NaN state, off the
table, a random rollout from an absurd velocity), the same messages as the
JAX package's ``err.get()``, word for word.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.core import PlanarRoboticsCore as JaxCore
from gymnasium_planar_robotics_tpu.models import debug as jdebug
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu_torch.core import PlanarRoboticsCore
from gymnasium_planar_robotics_tpu_torch.models import debug, planning

HOLED = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
CPARAMS = {
    'circle': {'shape': 'circle', 'size': 0.1, 'offset': 0.01, 'offset_wall': 0.005},
    'box': {'shape': 'box', 'size': [0.09, 0.08], 'offset': 0.004, 'offset_wall': 0.002},
}


def _qpos(rng, n):
    q = np.zeros((n, 7))
    q[:, :2] = rng.uniform(-0.05, 0.77, size=(n, 2))
    yaw = rng.uniform(-np.pi, np.pi, n)
    q[:, 3], q[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    return q


@pytest.mark.parametrize('shape', ['circle', 'box'])
def test_facade_matches_jax_facade(shape):
    core = PlanarRoboticsCore(HOLED, collision_params=CPARAMS[shape], device='cpu')
    ref = JaxCore(HOLED, collision_params=CPARAMS[shape])
    for a, b in zip(core.get_tile_xy_pos(), ref.get_tile_xy_pos()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    qpos = _qpos(rng, 512)
    for off in (False, True):
        got = core.qpos_is_valid(qpos, add_safety_offset=off)
        np.testing.assert_array_equal(got, ref.qpos_is_valid(qpos, add_safety_offset=off))
        np.testing.assert_array_equal(core.check_wall_collision(qpos, add_safety_offset=off),
                                      ref.check_wall_collision(qpos, add_safety_offset=off))
        assert 0 < got.sum() < len(got)
    for c_size in ((None, 0.12) if shape == 'circle' else (None, [0.1, 0.07])):
        np.testing.assert_array_equal(core.get_c_size_arr(c_size if c_size is not None else core.c_size, 3),
                                      ref.get_c_size_arr(c_size if c_size is not None else ref.c_size, 3))
    pairs = [(0.3, 0.45), (0.3, 0.52), (0.3, 0.3001)]
    for x0, x1 in pairs:
        pair = np.zeros((2, 7))
        pair[:, 3] = 1.0
        pair[0, :2], pair[1, :2] = [x0, 0.3], [x1, 0.3]
        for off in (False, True):
            assert core.check_mover_collision(pair, add_safety_offset=off) == \
                ref.check_mover_collision(pair, add_safety_offset=off)
    assert core.qpos_is_valid(qpos).dtype == ref.qpos_is_valid(qpos).dtype


def test_tile_indices_mask_matches_jax_facade():
    rng = np.random.default_rng(5)
    masks = [np.ones((3, 3)), np.array([[1, 1], [1, 0]]), np.array([[1, 1], [0, 1]]), np.array([[1, 0], [1, 1]]),
             np.array([[0, 1], [1, 1]]), np.ones((1, 2)), np.array([[1, 0, 1]]), np.ones((2, 3)), np.ones((7, 7))]
    for _ in range(4):
        layout = (rng.random((rng.integers(3, 6), rng.integers(3, 6))) > 0.3).astype(np.int8)
        layout[0, 0] = 1
        core, ref = PlanarRoboticsCore(layout, device='cpu'), JaxCore(layout)
        for mask in masks:
            for a, b in zip(core.get_tile_indices_mask(mask), ref.get_tile_indices_mask(mask)):
                np.testing.assert_array_equal(a, b, err_msg=str(mask.shape))


def _envs(std_noise):
    jc, jp = jplan.make_planning_env(np.ones((3, 3)), 1, std_noise=std_noise, dtype=jnp.float64)
    tc, tp = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=std_noise, dtype=torch.float64, device='cpu')
    return jc, jp, tc, tp


def _start(tc, tp):
    """A port state and the same state for the JAX package (one env)."""
    state = planning.init_batch(tc, tp, 1, torch.Generator().manual_seed(0))[0]
    d = planning.state_to_numpy(state)
    jstate = jplan.PlanningState(**{k: jnp.asarray(v[0]) for k, v in d.items()}, key=jax.random.PRNGKey(0))
    return state, jstate


def _pair(state, jstate, **fields):
    """Both states with ``fields`` (given for one env) replaced."""
    return (dataclasses.replace(state, **{k: torch.as_tensor(v)[None] for k, v in fields.items()}),
            dataclasses.replace(jstate, **{k: jnp.asarray(v) for k, v in fields.items()}))


def _both(jc, jp, tc, tp, state, jstate, action):
    err, out = debug.make_checked_step(tc, tp, planning.step)(state, torch.as_tensor(action)[None])
    jerr, jout = jdebug.make_checked_step(jc, jp, jplan.step)(jstate, jnp.asarray(action))
    return err, out, jerr, jout


def test_clean_step_passes():
    jc, jp, tc, tp = _envs(0.0)
    state, jstate = _start(tc, tp)
    err, _, jerr, _ = _both(jc, jp, tc, tp, state, jstate, np.zeros(2))
    assert err.get() is None and jerr.get() is None
    err.throw()


@pytest.mark.parametrize('field, msg', [('pos', 'non-finite mover position'), ('vel', 'non-finite mover position')])
def test_corrupted_state_raises_with_the_jax_message(field, msg):
    jc, jp, tc, tp = _envs(0.0)
    state, jstate = _start(tc, tp)
    bad, jbad = _pair(state, jstate, **{field: np.full((1, 2), np.nan)})
    err, _, jerr, _ = _both(jc, jp, tc, tp, bad, jbad, np.zeros(2))
    assert err.get() == jerr.get() and err.get().startswith(msg)
    with pytest.raises(debug.InvariantError, match=msg):
        err.throw()


def test_off_table_terminates_instead_of_tripping():
    jc, jp, tc, tp = _envs(0.0)
    state, jstate = _start(tc, tp)
    far, jfar = _pair(state, jstate, pos=np.array([[5.0, 5.0]]))
    err, (s, o, r, term, tr, info), jerr, jout = _both(jc, jp, tc, tp, far, jfar, np.zeros(2))
    assert err.get() is None and jerr.get() is None
    assert bool(term[0]) and float(r[0]) == -50.0 == float(jout[2])


def test_invariants_hold_over_random_rollout_and_extra_checks():
    """From an absurd velocity the clamp chain is back under v_max within a
    step; an extra invariant reports through ``check`` and comes after the
    defaults, as a ``checkify.check`` in ``extra_invariants`` does."""
    jc, jp, tc, tp = _envs(1e-5)
    state, _ = _start(tc, tp)
    state = dataclasses.replace(state, vel=torch.tensor([[[200.0, 0.0]]], dtype=torch.float64))
    seen = []

    def extra(config, params, st, out, check):
        seen.append(out[0].steps)
        check(out[0].steps < 3, 'the episode ran past step 2')

    checked = debug.make_checked_step(tc, tp, planning.step, extra_invariants=extra)
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    msgs = []
    for _ in range(5):
        action = torch.as_tensor(rng.uniform(-10.0, 10.0, (1, 2)))
        err, (state, *_rest) = checked(state, action)
        msgs.append(err.get())
    assert msgs[:2] == [None, None] and msgs[2] == 'the episode ran past step 2 (`check` failed)'
    assert float(torch.linalg.vector_norm(state.vel)) <= float(tp.v_max) + 1e-6
    assert len(seen) == 5
