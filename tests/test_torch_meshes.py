"""Port parity: ``utils/meshes``, the port's own copy of the JAX package's
STL support (parsing, AABB half-extents, the predefined-mesh generator),
and a mesh mover with a bumper stepping through planning's fused kernel F.

Both modules generate each predefined mesh into a directory of their own
here; the STL bytes and the half-extents must be equal.  The port's default
directory is its own git-ignored ``assets/``, never the JAX package's.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.utils import meshes as jmeshes
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.utils import meshes

from test_torch_planning_autoreset import TOL, TOL_ACC, episode_state, to_jax_state

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'gymnasium_planar_robotics_tpu_torch'


@pytest.mark.parametrize('name', sorted(jmeshes.PREDEFINED_MESH_DIMS))
def test_predefined_mesh_matches_jax(name, tmp_path):
    assert meshes.PREDEFINED_MESH_DIMS[name] == jmeshes.PREDEFINED_MESH_DIMS[name]
    got = meshes.resolve_mesh_path(name, tmp_path / 'port')
    want = jmeshes.resolve_mesh_path(name, tmp_path / 'jax')
    assert got.read_bytes() == want.read_bytes()
    for scale in ((1.0, 1.0, 1.0), (1.5, 0.5, 2.0)):
        h = meshes.resolve_mover_size('mesh', None, name, scale, asset_dir=tmp_path / 'port')
        np.testing.assert_array_equal(h, jmeshes.resolve_mover_size('mesh', None, name, scale,
                                                                    asset_dir=tmp_path / 'jax'))
    # the AABB is the datasheet's outer dimensions (f32 vertices)
    np.testing.assert_allclose(2 * meshes.mesh_half_extents(got), jmeshes.PREDEFINED_MESH_DIMS[name], rtol=1e-6)


def test_ascii_stl_and_direct_sizes(tmp_path):
    path = tmp_path / 'tri.stl'
    path.write_text('solid t\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\nvertex 0.2 0 0\nvertex 0 0.1 0.04\n'
                    'endloop\nendfacet\nendsolid t\n')
    np.testing.assert_array_equal(meshes.read_stl_vertices(path), jmeshes.read_stl_vertices(path))
    np.testing.assert_array_equal(meshes.mesh_half_extents(path), [0.1, 0.05, 0.02])
    for shape in ('box', 'cylinder'):
        np.testing.assert_array_equal(meshes.resolve_mover_size(shape, [0.1, 0.2, 0.3]), [0.1, 0.2, 0.3])
    with pytest.raises(ValueError, match='unknown mover shape'):
        meshes.resolve_mover_size('sphere', [0.1, 0.1, 0.1])
    assert meshes.resolve_mesh_path(None) is None and meshes.resolve_mesh_path(str(path)) == path


def test_stale_asset_regenerates(tmp_path):
    name = 'beckhoff_apm4330_bumper'
    path = tmp_path / f'{name}.stl'
    meshes.write_box_stl(path, (1.0, 1.0, 1.0))  # no generator tag
    meshes.resolve_mesh_path(name, tmp_path)
    assert path.read_bytes()[:80].startswith(b'gprt-stl-v2')
    np.testing.assert_allclose(2 * meshes.mesh_half_extents(path), meshes.PREDEFINED_MESH_DIMS[name], rtol=1e-6)


def test_constructors_write_into_the_ports_own_assets():
    """Mesh movers of both families are sized from STLs in the port's
    git-ignored ``assets/``; the JAX package's directory is not the default."""
    assert meshes.ASSET_DIR == PKG / 'assets'
    assert 'gymnasium_planar_robotics_tpu_torch/assets/*.stl' in (ROOT / '.gitignore').read_text().splitlines()
    _, prm = tpush.make_pushing_env(mover_params={'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}, device='cpu')
    _, pprm = tplan.make_planning_env(np.ones((3, 3)), 1, mover_params={'shape': 'mesh'}, device='cpu')
    assert (meshes.ASSET_DIR / 'beckhoff_apm4330_mover.stl').is_file()
    np.testing.assert_allclose(prm.mover_half.numpy(), [0.07, 0.07])
    np.testing.assert_allclose(pprm.mover_size.numpy()[0], [0.07, 0.07, 0.00605], rtol=1e-6)
    np.testing.assert_allclose(float(prm.accel_scale), 1.24 / 1.59, rtol=1e-6)
    np.testing.assert_allclose(float(pprm.accel_scale[0]), 1.24 / 1.34, rtol=1e-6)


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_mesh_bumper_planning_step_matches_jax(learn_jerk):
    """One fused planning autoreset step of a mesh mover with a bumper
    (``accel_scale`` = 1.24 / 1.59 in the kernel's integration and in the
    state's acceleration) against the JAX Pallas step, interpret mode,
    injected uniforms; tolerances of ``test_torch_planning_autoreset``."""
    kw = dict(mover_params={'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}, learn_jerk=learn_jerk,
              std_noise=[2e-4, 5e-3, 1e-5], num_cycles=10)
    jcfg, jprm = jplan.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float32, **kw)
    tcfg, tprm = tplan.make_planning_env(np.ones((3, 3)), 1, device='cpu', **kw)
    b = 128
    state = episode_state(tcfg, tprm, b, seed=6)
    jstep = jplan.make_fused_step_autoreset(jcfg, jprm, interpret=True, inject_noise=True, cand_k=2)
    tstep = tplan.make_fused_step_autoreset(tcfg, tprm, cand_k=2)
    rng = np.random.default_rng(7)
    lim = 80.0 if learn_jerk else 8.0
    act = rng.uniform(-lim, lim, (b, 2)).astype(np.float32)
    u = rng.random((tstep.noise_planes, b), dtype=np.float32)
    js, jobs, jr, jt, jtr, ji = jstep(to_jax_state(state), jnp.asarray(act), noise=jnp.asarray(u))
    ts, tobs, tr, tt, ttr, ti = tstep(state, torch.from_numpy(act), noise=torch.from_numpy(u))
    for k in ('pos', 'vel', 'goals'):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL, err_msg=k)
    for k in ('acc', 'act'):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **TOL_ACC, err_msg=k)
    np.testing.assert_allclose(tobs['observation'].numpy(), np.asarray(jobs['observation']), **TOL_ACC)
    for k in ('wall_collision', 'reset_stalled', 'reset_trials'):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert 0 < int(ti['wall_collision'].sum()) < b
    # jerk mode: the bumper's mass scales the integrator's activation down
    # to the mover's acceleration
    if learn_jerk:
        moving = ~(tt | ttr).numpy()
        scale = float(tprm.accel_scale[0])
        np.testing.assert_allclose(ts.acc.numpy()[moving], (scale * ts.act).numpy()[moving], rtol=1e-6)
