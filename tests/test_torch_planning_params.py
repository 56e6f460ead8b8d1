"""Port parity: planning params, kernel constants, numpy converters, grid,
validation, the default device and what is not ported yet.

The torch port's ``make_planning_env`` must reproduce every leaf of the JAX
package's ``make_planning_env(dtype=float32)`` exactly, for circle and box
collision shapes, full and holed layouts, acc and jerk actuation, and its
kernel constants must equal the ones the Pallas kernels bake in.
"""

import dataclasses
import functools
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu.ops.grid import make_tile_grid as jax_make_tile_grid
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops.grid import make_tile_grid
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import walls

PKG = Path(__file__).resolve().parents[1] / 'gymnasium_planar_robotics_tpu_torch'
FULL = np.ones((3, 3))
HOLED = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
L_SHAPE = np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]])  # two missing diagonal corners
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}

CASES = {
    'circle_full_acc': (FULL, 1, {}),
    'circle_holed_jerk': (HOLED, 1, {'learn_jerk': True, 'num_cycles': 10}),
    'box_full_jerk': (FULL, 1, {'collision_params': BOX, 'learn_jerk': True}),
    'box_lshape_custom': (L_SHAPE, 1, {
        'collision_params': {'shape': 'box', 'size': [0.08, 0.1], 'offset': 0.01, 'offset_wall': 0.005},
        'std_noise': [1e-4, 2e-4, 3e-5], 'mover_params': {'mass': 1.5, 'size': [0.07, 0.07, 0.008]},
        'threshold_pos': 0.05, 'reward_mode': 'dense',
    }),
    'circle_4x5_offsets': (np.ones((4, 5)), 1, {
        'collision_params': {'size': 0.12, 'offset': 0.02, 'offset_wall': 0.003}, 'v_max': 1.0, 'a_max': 8.0,
    }),
    'two_movers': (FULL, 2, {}),
    # mesh movers with a bumper (the JAX package's tests/test_pushing_env.py:288 settings)
    'mesh_bumper': (FULL, 1, {'mover_params': {'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}}),
    'mesh_bumpers_two_box': (FULL, 2, {'mover_params': {'shape': 'mesh', 'mesh': {'bumper_mass': [0.3, 0.4]}},
                                       'collision_params': {'shape': 'box', 'size': [0.08, 0.08]}}),
}


def jax_params_np(params) -> dict:
    d = {f.name: np.asarray(getattr(params, f.name)) for f in dataclasses.fields(params) if f.name != 'grid'}
    d['grid'] = {f.name: np.asarray(getattr(params.grid, f.name)) for f in dataclasses.fields(params.grid)}
    return d


def _pair(case):
    layout, m, kw = CASES[case]
    jcfg, jprm = jplan.make_planning_env(layout, m, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(layout, m, device='cpu', **kw)
    return jcfg, jprm, tcfg, tprm


def assert_params_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        if name == 'grid':
            for g in want['grid']:
                w, h = want['grid'][g], got['grid'][g]
                assert h.dtype == w.dtype and h.shape == w.shape, (g, h.dtype, w.dtype, h.shape, w.shape)
                np.testing.assert_array_equal(h, w, err_msg=f'grid.{g}')
            continue
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize('case', sorted(CASES))
def test_params_match_jax_exactly(case):
    """Every PlanningParams leaf, dtype and shape included (exact)."""
    jcfg, jprm, tcfg, tprm = _pair(case)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_params_equal(tplan.params_to_numpy(tprm), jax_params_np(jprm))


@pytest.mark.parametrize('case', sorted(CASES))
def test_jax_params_through_numpy_equal_the_ports_own(case):
    """The converters carry the JAX package's params across bit for bit,
    and the port's own params round-trip; states drop the JAX key."""
    jcfg, jprm, tcfg, tprm = _pair(case)
    carried = tplan.params_from_numpy(jax_params_np(jprm), device='cpu')
    assert_params_equal(tplan.params_to_numpy(carried), tplan.params_to_numpy(tprm))
    if case != 'circle_full_acc':
        return
    jstate, _, _ = jplan.init_batch(jcfg, jprm, jax.random.PRNGKey(3), 16)
    d = {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    state = tplan.state_from_numpy(d, device='cpu')
    back = tplan.state_to_numpy(state)
    assert set(back) == set(d) - {'key'}
    for name, v in back.items():
        np.testing.assert_array_equal(v, d[name])
        assert v.dtype == d[name].dtype and v.shape == d[name].shape
    # the kernels' plane layout round-trips pos, vel, goals and steps
    again = tplan.planes_to_state(tcfg, tplan.state_to_planes(tcfg, state), 1.0)
    for name in ('pos', 'vel', 'goals', 'steps'):
        np.testing.assert_array_equal(getattr(again, name).numpy(), d[name])


def _find_partial_kw(fn, key):
    """The keyword ``key`` of the first functools.partial in ``fn``'s closures."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        if isinstance(f, functools.partial) and key in f.keywords:
            return f.keywords
        for cell in getattr(f, '__closure__', None) or ():
            todo.append(cell.cell_contents)
    raise LookupError(key)


@pytest.mark.parametrize('case', [c for c in sorted(CASES) if CASES[c][1] == 1])
def test_kernel_constants_match_pallas(case):
    """The kernels' constants are the f32 roundings of the keywords the JAX
    wrappers bind into the Pallas kernels (the spans formed in float64
    first), and their wall rule is built from the same grid snapshot."""
    jcfg, jprm, tcfg, tprm = _pair(case)
    want = _find_partial_kw(pallas_step.make_fused_planning_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=3),
                            'reset_consts')
    got_grid = walls.grid_np(tprm)
    assert set(got_grid) == set(want['grid_np'])
    for g in want['grid_np']:
        np.testing.assert_array_equal(got_grid[g], want['grid_np'][g], err_msg=g)

    kc = kplan.make_kernel_consts(tcfg, tprm, 3)
    want_rule = walls.make_wall_rule(want['grid_np'])
    assert (kc.rule.full, kc.rule.rect, kc.rule.cells) == (want_rule.full, want_rule.rect, want_rule.cells)
    np.testing.assert_array_equal(kc.rule.table, want_rule.table)
    rc = want['reset_consts']
    f32 = walls.f32
    wx, wy = want['wall_size'] if want['box'] else (want['wall_size'],) * 2
    sx, sy = want['sample_size'] if want['box'] else (want['sample_size'],) * 2
    expect = {'wall_x': wx, 'wall_y': wy, 'sample_x': sx, 'sample_y': sy,
              'span_x': rc['max_x'] - rc['min_x'], 'span_y': rc['max_y'] - rc['min_y'],
              'threshold': rc['threshold'], 'max_episode_steps': rc['max_episode_steps'],
              'min_x': rc['min_x'], 'min_y': rc['min_y']}
    expect.update({k: want[k] for k in ('v_max', 'a_max', 'dt', 'std_pos', 'std_vel', 'accel_scale')})
    if jprm.grid.layout.all():
        (x0, x1, y0, y1), fast = pallas_step._full_layout_bounds(want['grid_np'])
        expect.update(x0=x0, x1=x1, y0=y0, y1=y1, has_fast=float(fast is not None))
    for k, v in expect.items():
        assert kc.f[k] == f32(v), (k, kc.f[k], v)
    assert kc.vector.dtype == np.float32 and kc.vector.shape == (len(kplan.PLANNING_FIELDS),)
    assert (kc.num_cycles, kc.cand_k, kc.learn_jerk, kc.box) == (want['num_cycles'], rc['cand_k'], want['learn_jerk'],
                                                                 want['box'])
    assert kc.rule.full == bool(np.asarray(jprm.grid.layout).all())
    # noise plane counts of the three kernels
    for cand_k in (2, 16):
        box = want['box']
        assert kplan.autoreset_noise_planes(jcfg.num_cycles, cand_k, box) == \
            pallas_step._planning_autoreset_noise_planes(jcfg.num_cycles, cand_k, box)
        assert kplan.cycles_noise_planes(jcfg.num_cycles, box) == pallas_step._step_noise_planes(jcfg.num_cycles, box)


def test_planning_fields_match_cuda_struct():
    """The constants vector's field order is the X-macro order of
    gprt::PlanningConsts in csrc/planning.cuh; the wall table's layout and
    flags are walls.cuh's."""
    src = (PKG / 'csrc' / 'planning.cuh').read_text()
    block = src.split('#define GPRT_PLANNING_FIELDS(X)')[1].split('#define')[0]
    assert tuple(re.findall(r'X\((\w+)\)', block)) == kplan.PLANNING_FIELDS
    wsrc = (PKG / 'csrc' / 'walls.cuh').read_text()
    assert f'kCellFloats = {walls.CELL_FLOATS};' in wsrc and f'kCornerFloats = {walls.CORNER_FLOATS};' in wsrc
    for name, value in (('kLayout', walls.LAYOUT), ('kComplete', walls.COMPLETE), ('kNbXm', walls.NB_XM),
                        ('kNbXp', walls.NB_XP), ('kNbYm', walls.NB_YM), ('kNbYp', walls.NB_YP),
                        ('kDiagXmYm', walls.DIAG_XM_YM), ('kDiagXmYp', walls.DIAG_XM_YP),
                        ('kDiagXpYm', walls.DIAG_XP_YM), ('kDiagXpYp', walls.DIAG_XP_YP)):
        assert re.search(rf'\b{name} = {value},', wsrc), name


@pytest.mark.parametrize('layout', [FULL, HOLED, L_SHAPE, np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]]),
                                    np.array([[1, 0, 1, 1], [1, 1, 1, 0]])], ids=['full', 'holed', 'lshape', 'ring', 'odd'])
def test_tile_grid_matches_jax(layout):
    """``make_tile_grid`` on holed layouts: centres, complete-3x3 cells and
    the missing-corner sites equal the JAX package's."""
    want = jax_make_tile_grid(layout, np.array([0.12, 0.12, 0.0176]), dtype=jnp.float32)
    got = make_tile_grid(layout, np.array([0.12, 0.12, 0.0176]), dtype=torch.float32, device='cpu')
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize('kwargs', [
    {'layout_tiles': np.zeros((3, 3))},
    {'layout_tiles': np.ones((3, 3)), 'tile_params': {'size': np.array([0.12, 0.12])}},
    {'layout_tiles': np.ones((3, 3)), 'mover_params': {'mass': -1.0}},
    {'layout_tiles': np.ones((3, 3)), 'initial_mover_zpos': -0.1},
    {'layout_tiles': np.ones((3, 3)), 'std_noise': [1e-5, 1e-5]},
    {'layout_tiles': np.ones((3, 3)), 'mover_params': {'size': [0.0, 0.07, 0.006]}},
], ids=['no_tiles', 'tile_size_shape', 'mass', 'zpos', 'std_shape', 'mover_size'])
def test_validation_raises_where_jax_raises(kwargs):
    kw = dict(kwargs)
    layout = kw.pop('layout_tiles')
    with pytest.raises(AssertionError) as want:
        jplan.make_planning_env(layout, 1, dtype=jnp.float32, **kw)
    with pytest.raises(AssertionError) as got:
        tplan.make_planning_env(layout, 1, device='cpu', **kw)
    assert str(got.value) == str(want.value)


def test_small_collision_shape_warns_like_jax():
    kw = {'collision_params': {'size': 0.05}}
    for make, extra in ((jplan.make_planning_env, {'dtype': jnp.float32}), (tplan.make_planning_env, {'device': 'cpu'})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            make(FULL, 1, **kw, **extra)
        assert any('smaller than the mover diagonal' in str(x.message) for x in w)


def test_default_device_is_the_card():
    """No ``device``: the tensors go to the card, or building them raises
    where there is none; nothing falls back to the CPU."""
    makers = (lambda **kw: tpush.make_pushing_env(**kw), lambda **kw: tplan.make_planning_env(FULL, 1, **kw))
    for make in makers:
        _, prm = make(device='cpu')
        assert prm.dt.device.type == 'cpu' and prm.grid.tile_x.device.type == 'cpu'
        if torch.cuda.is_available():
            _, prm = make()
            assert prm.dt.device.type == 'cuda' and prm.grid.tile_x.device.type == 'cuda'
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            make_tile_grid(FULL)


def test_not_ported_paths_raise():
    """What still raises: ``make_fused_step`` with M > 1 (the JAX package has
    no such path either), more movers than kernel H takes (64) and f64 on the
    fused paths (the eager step takes both), mesh movers; dense rewards on
    the fused rollout; and what the reactive rollout does not cover in the
    JAX package either (M > 1, jerk, f64)."""
    cfg2, prm2 = tplan.make_planning_env(FULL, 2, device='cpu')
    with pytest.raises(NotImplementedError, match='no M-mover make_fused_step'):
        tplan.make_fused_step(cfg2, prm2)
    cfg65, prm65 = tplan.make_planning_env(np.ones((20, 20)), 65, device='cpu')
    for make in (tplan.make_fused_step_autoreset, tplan.make_fused_rollout):
        with pytest.raises(NotImplementedError, match='2 to 64 movers'):
            make(cfg65, prm65)
    for m in (1, 2):
        cfg64, prm64 = tplan.make_planning_env(FULL, m, dtype=torch.float64, device='cpu')
        makers = (tplan.make_fused_step_autoreset, tplan.make_fused_rollout) + ((tplan.make_fused_step,) if m == 1
                                                                                 else ())
        for make in makers:
            with pytest.raises(NotImplementedError, match='f64'):
                make(cfg64, prm64)
    cfg9e, prm9e = tplan.make_planning_env(np.ones((6, 6)), 9, num_cycles=2, dtype=torch.float64, device='cpu')
    g = torch.Generator().manual_seed(0)
    state9 = tplan.init_batch(cfg9e, prm9e, 3, g)[0]
    for fn in (tplan.step, tplan.step_autoreset, tplan.batched_step):
        out = fn(cfg9e, prm9e, state9, torch.zeros((3, 9, 2), dtype=torch.float64), generator=g)
        assert out[0].pos.shape == (3, 9, 2) and out[0].pos.dtype == torch.float64
    # the reactive rollout's own limits, as the JAX function asserts them:
    # 1 mover, acc mode, f32
    for (c, p), what in (((cfg2, prm2), '1 mover'),
                         (tplan.make_planning_env(FULL, 1, learn_jerk=True, device='cpu'), 'acc mode'),
                         (tplan.make_planning_env(FULL, 1, dtype=torch.float64, device='cpu'), 'f32')):
        with pytest.raises(ValueError, match=what):
            tplan.make_reactive_rollout(c, p, None, 4)
    cfg_d, prm_d = tplan.make_planning_env(FULL, 1, reward_mode='dense', device='cpu')
    with pytest.raises(ValueError, match='sparse reward'):
        tplan.make_fused_rollout(cfg_d, prm_d)
    with pytest.raises(ValueError, match='reward_mode'):
        tplan.make_planning_env(FULL, 1, reward_mode='shaped', device='cpu')
