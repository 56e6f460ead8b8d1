"""Port parity: pushing params, kernel constants, numpy converters, imports.

The torch port's ``make_pushing_env`` must reproduce every leaf of the JAX
package's ``make_pushing_env(dtype=float32)`` exactly, and its kernel
constants must equal the ones the Pallas kernels bake in (same float64
arithmetic, same f32 rounding).
"""

import dataclasses
import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'gymnasium_planar_robotics_tpu_torch'

# the JAX package's mesh-bumper pushing settings (tests/test_pushing_env.py:288)
MESH_BUMPER = {'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}
CASES = {
    'default': {},
    'box': {'collision_params': {'shape': 'box', 'size': [0.1, 0.1]}},
    'mesh_bumper': {'mover_params': MESH_BUMPER},
    'box_mesh_bumper_jerk': {
        'collision_params': {'shape': 'box', 'size': [0.09, 0.08], 'offset': 0.01, 'offset_wall': 0.005},
        'mover_params': MESH_BUMPER, 'learn_jerk': True, 'num_cycles': 10,
    },
    'jerk': {'learn_jerk': True, 'num_cycles': 10},
    'custom_collision': {
        'collision_params': {'size': 0.1, 'offset': 0.01, 'offset_wall': 0.005},
        'std_noise': [1e-4, 2e-4, 3e-5],
        'mover_params': {'mass': 1.5, 'size': [0.07, 0.07, 0.008]},
    },
}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_params_np(params) -> dict:
    d = {f.name: np.asarray(getattr(params, f.name)) for f in dataclasses.fields(params) if f.name != 'grid'}
    d['grid'] = {f.name: np.asarray(getattr(params.grid, f.name)) for f in dataclasses.fields(params.grid)}
    return d


def _pair(case):
    kw = CASES[case]
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    return jcfg, jprm, tcfg, tprm


@pytest.mark.parametrize('case', sorted(CASES))
def test_params_match_jax_exactly(case):
    """Every PushingParams leaf, dtype and shape included (exact)."""
    jcfg, jprm, tcfg, tprm = _pair(case)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = jax_params_np(jprm)
    got = tpush.params_to_numpy(tprm)
    assert set(got) == set(want)
    for name in want:
        if name == 'grid':
            for g in want['grid']:
                w, h = want['grid'][g], got['grid'][g]
                assert h.dtype == w.dtype and h.shape == w.shape, (g, h.dtype, w.dtype, h.shape, w.shape)
                np.testing.assert_array_equal(h, w, err_msg=f'grid.{g}')
            continue
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _find_partial_kw(fn, key):
    """The keyword ``key`` of the first functools.partial in ``fn``'s closures."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        if isinstance(f, functools.partial) and key in f.keywords:
            return f.keywords[key]
        for cell in getattr(f, '__closure__', None) or ():
            todo.append(cell.cell_contents)
    raise LookupError(key)


@pytest.mark.parametrize('case', sorted(CASES))
def test_kernel_constants_match_pallas(case):
    """_pushing_consts and the restart constants equal the JAX ones exactly,
    and the f32 constants vector holds their f32 roundings (the Python
    float64 sums formed as the Pallas kernel forms them)."""
    jcfg, jprm, tcfg, tprm = _pair(case)
    want = pallas_step._pushing_consts(jcfg, jprm)
    got = kpush.pushing_consts(tcfg, tprm)
    assert set(got) == set(want)
    for k in want:
        if k == 'grid_np':
            for g in want[k]:
                np.testing.assert_array_equal(got[k][g], want[k][g], err_msg=g)
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), (k, got[k], want[k])

    fused = pallas_step.make_fused_pushing_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=5)
    want_rc = _find_partial_kw(fused, 'reset_consts')
    assert kpush.reset_consts(tcfg, tprm, 5) == want_rc

    kc = kpush.make_kernel_consts(tcfg, tprm, 5)
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    (x0, x1, y0, y1), fast = pallas_step._full_layout_bounds(want['grid_np'])
    wall_x, wall_y = want['wall_size'] if want['box'] else (want['wall_size'],) * 2
    expect = {
        'dt': want['dt'], 'mu_g_dt': want['mu_g_dt'], 'plow_unit': want['plow_unit'],
        'conez_unit': want['conez_unit'], 'wall_x': wall_x, 'wall_y': wall_y,
        'damp': 1.0 + want['dt'] * want['obj_damping'] / want['obj_mass'],
        'damp_w': 1.0 + want['dt'] * want['obj_damping'] / want['obj_inertia'],
        'mu_spin_dt': want['mu_spin'] * want['dt'],
        'cone_vt_span': want['cone_vt_off'] - want['cone_vt_hi'],
        'x0': x0, 'x1': x1, 'y0': y0, 'y1': y1, 'fx0': fast[0], 'fy1': fast[3],
        'span_x': want_rc['max_x'] - want_rc['min_x'],
        'obj_span_y': want_rc['obj_max_y'] - want_rc['obj_min_y'],
        'min_mo': want_rc['min_mo'], 'threshold': want_rc['threshold'],
    }
    for k, v in expect.items():
        assert kc.f[k] == f32(v), (k, kc.f[k], v)
    assert kc.vector.dtype == np.float32 and kc.vector.shape == (len(kpush.CONST_FIELDS),)
    assert (kc.num_cycles, kc.cand_k, kc.learn_jerk, kc.box) == (jcfg.num_cycles, 5, jcfg.learn_jerk, want['box'])
    for cand_k in (2, 32):
        assert kpush.autoreset_noise_planes(jcfg.num_cycles, cand_k, kc.box) == \
            pallas_step._pushing_autoreset_noise_planes(jcfg.num_cycles, cand_k, want['box'])
    assert kpush.cycles_noise_planes(jcfg.num_cycles, kc.box) == \
        pallas_step._pushing_cycles_noise_planes(jcfg.num_cycles, want['box'])


def test_const_fields_match_cuda_struct():
    """The constants vector's field order is the X-macro order of
    gprt::Consts in csrc/pushing.cuh (the bytes the kernels read)."""
    src = (PKG / 'csrc' / 'pushing.cuh').read_text()
    block = src.split('#define GPRT_CONST_FIELDS(X)')[1].split('#define')[0]
    assert tuple(re.findall(r'X\((\w+)\)', block)) == kpush.CONST_FIELDS
    # the build compiles every source and hashes every header it finds
    names = {path.name for path in build.sources() + build.headers()}
    assert {'noise_probe.cu', 'pushing_cycles.cu', 'pushing_autoreset.cu', 'pushing_rollout.cu',
            'common.cuh', 'walls.cuh', 'pushing.cuh'} <= names, names
    assert 'arch=compute_90a,code=sm_90a' in build.NVCC_FLAGS
    assert '--use_fast_math' not in build.NVCC_FLAGS


@pytest.mark.parametrize('case', sorted(CASES))
def test_numpy_round_trip_is_lossless(case):
    jcfg, jprm, tcfg, tprm = _pair(case)
    want = jax_params_np(jprm)
    back = tpush.params_to_numpy(tpush.params_from_numpy(want, device='cpu'))
    for name in want:
        if name == 'grid':
            for g in want['grid']:
                np.testing.assert_array_equal(back['grid'][g], want['grid'][g])
                assert back['grid'][g].dtype == want['grid'][g].dtype
        else:
            np.testing.assert_array_equal(back[name], want[name])
            assert back[name].dtype == want[name].dtype

    jstate, _, _ = jpush.init_batch(jcfg, jprm, jax.random.PRNGKey(3), 16)
    jnp_state = {f.name: np.asarray(getattr(jstate, f.name)) for f in dataclasses.fields(jstate)}
    port_state = tpush.state_from_numpy(jnp_state, device='cpu')  # drops the key
    assert not hasattr(port_state, 'key')
    back = tpush.state_to_numpy(port_state)
    assert set(back) == set(jnp_state) - {'key'}
    for name, v in back.items():
        np.testing.assert_array_equal(v, jnp_state[name])
        assert v.dtype == jnp_state[name].dtype and v.shape == jnp_state[name].shape
    # the kernels' plane layout round-trips too
    again = tpush.state_to_numpy(tpush.planes_to_state(tpush.state_to_planes(port_state)))
    for name, v in again.items():
        np.testing.assert_array_equal(v, jnp_state[name])


def test_emit_features_raises():
    """The public step takes no ``emit_features``, as the JAX package's
    (the flag lives on the kernel wrapper, ``kpush.pushing_autoreset``, and
    the reactive rollout sets it)."""
    cfg, prm = tpush.make_pushing_env(num_cycles=2, device='cpu')
    with pytest.raises(TypeError, match='emit_features'):
        tpush.make_fused_step_autoreset(cfg, prm, emit_features=True)


@pytest.mark.parametrize('make', [tpush.make_fused_step, tpush.make_fused_step_autoreset, tpush.make_fused_rollout])
def test_fused_paths_reject_dense_reward(make):
    cfg, prm = tpush.make_pushing_env(num_cycles=2, reward_mode='dense', device='cpu')
    with pytest.raises(ValueError, match='sparse reward'):
        make(cfg, prm)
    with pytest.raises(ValueError, match='reward_mode'):
        tpush.make_pushing_env(reward_mode='shaped', device='cpu')


def test_port_imports_neither_jax_nor_the_jax_package():
    """Source scan plus a fresh interpreter: importing the port's modules
    loads no jax and no gymnasium_planar_robotics_tpu, and needs no triton."""
    pat = re.compile(r'^\s*(import jax|from jax|import gymnasium_planar_robotics_tpu\b(?!_torch)'
                     r'|from gymnasium_planar_robotics_tpu\b(?!_torch))', re.M)
    for path in PKG.rglob('*.py'):
        assert not pat.search(path.read_text()), path
    code = (
        'import sys\n'
        'import gymnasium_planar_robotics_tpu_torch.models.pushing\n'
        'import gymnasium_planar_robotics_tpu_torch.ops.kernels.build\n'
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'triton'"
        " or m.startswith('gymnasium_planar_robotics_tpu.') or m == 'gymnasium_planar_robotics_tpu']\n"
        'assert not bad, bad\n'
    )
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)
