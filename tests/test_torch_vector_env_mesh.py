"""The vector envs over a device mesh (``envs/vector_env.py`` with
``mesh=``, ``envs/runner.VectorRunner``) on gloo ranks.

The ranks are processes (``tests/torch_sharding_worker.py ... vector``,
running ``tests/torch_vector_mesh_cases.py``) that meet on a ``FileStore``
in the test's temporary directory; the JAX half runs here meanwhile, on
meshes cut from the conftest's eight virtual CPU devices.

- World size 1: the envs over the mesh equal the unsharded envs from the
  same seed over a reset and 5 steps, eager and fused, bit for bit.
- 2 and 4 ranks, 1-mover planning and pushing, ``std_noise=0``, from the
  JAX vector env's reset state (planning's goals moved 0.3 m away, so no
  env finishes in the 3 steps): every rank's gathered outputs and the
  gathered state equal the JAX ``PlanningVectorEnv`` / ``PushingVectorEnv``
  over a 2- and a 4-device mesh, made fused in interpret mode as
  ``tests/test_adapters.py:309-318`` makes it, at the fused-step tolerances
  of ``test_torch_sharding.py``: rtol 2e-6 / atol 2e-6, the acceleration
  and activation leaves rtol 1e-4 / atol 1e-5, flags, counters and the
  sparse rewards exact.  Both sides draw all-zero uniforms (interpret
  mode's hardware bits; the port's ``kernels.draw_uniforms`` patched).
- With wall hits and truncation restarts on 2 ranks, eager and fused:
  each rank's rows of the gathered outputs, and its state, equal the
  unsharded step on its shard under the generator
  ``sharding.rank_generator`` splits off for each call, bit for bit.
- Each step makes one collective, whatever the dtypes of its outputs
  (world sizes 1, 2 and 4).  (An uneven split's ``ValueError`` is held by
  ``test_torch_adapters.py::test_vector_env_mesh_not_ported``.)
"""

import os
import subprocess
import sys
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gymnasium_planar_robotics_tpu.envs import vector_env as jvec
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu.parallel import sharding as jsharding
import torch_vector_mesh_cases as vcases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_sharding_worker.py')
TOL = dict(rtol=2e-6, atol=2e-6)
TOL_ACC = dict(rtol=1e-4, atol=1e-5)
RUNS = {'world1': ('world1', 1), 'jax2': ('jax', 2), 'jax4': ('jax', 4), 'restarts2': ('restarts', 2)}


def _launch(d, rank, world):
    log = open(os.path.join(d, f'vector_rank{rank}.log'), 'w')
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    return subprocess.Popen([sys.executable, WORKER, str(rank), str(world), str(d), 'vector'], stdout=log,
                            stderr=subprocess.STDOUT, cwd=ROOT, env=env), log


def _jax_env(family, mesh):
    kw = dict(num_cycles=4, dtype=jnp.float32, mesh=mesh, std_noise=0.0)
    if family == 'planning_m1':
        return jvec.PlanningVectorEnv(num_envs=vcases.B_JAX, num_movers=1, **kw)
    return jvec.PushingVectorEnv(num_envs=vcases.B_JAX, **kw)


def _start_state(family):
    """The JAX env's reset state (seed 0) as numpy, planning's goals moved
    0.3 m along x, toward the table's middle."""
    venv = _jax_env(family, None)
    venv.reset(seed=0)
    d = {k: np.asarray(getattr(venv.device_state, k)) for k in venv.device_state.__dataclass_fields__ if k != 'key'}
    if family == 'planning_m1':
        x = d['pos'][..., 0]
        d['goals'] = d['pos'].copy()
        d['goals'][..., 0] = np.where(x < 0.36, x + 0.3, x - 0.3)
    return d


def _jax_run(family, world, start, actions):
    """The JAX vector env over a ``world``-device mesh from ``start``: the
    flat outputs of each step and the final state."""
    mesh = jsharding.make_mesh(jax.devices()[:world])
    venv = _jax_env(family, mesh)
    assert venv.using_fused, 'the sharded fused dispatch did not engage'
    venv.reset(seed=0)
    cls = type(venv.device_state)
    state = cls(**{k: jnp.asarray(v) for k, v in start.items()}, key=venv.device_state.key)
    venv._state = jax.device_put(state, NamedSharding(mesh, P('data')))
    out = {}
    for t, a in enumerate(actions):
        res = venv.step(a)
        assert not res[2].any() and not res[3].any(), 'an env finished'
        out.update({f't{t}/{k}': v for k, v in vcases.flat(res).items()})
    out.update({f'state.{k}': np.asarray(getattr(venv.device_state, k)) for k in start})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('vector_mesh')
    rng = np.random.default_rng(3)
    starts = {f: _start_state(f) for f in vcases.FAMILIES}
    actions = {f: rng.uniform(-1.0, 1.0, (vcases.T_JAX, vcases.B_JAX, 2)).astype(np.float32) for f in starts}
    procs = []
    for name, (scenario, world) in RUNS.items():
        d = base / name
        d.mkdir()
        inputs = {'scenario': np.asarray(scenario)}
        for f in starts:
            inputs.update({f'{f}/state.{k}': v for k, v in starts[f].items()})
            inputs[f'{f}/actions'] = actions[f]
        np.savez(d / 'inputs.npz', **inputs)
        procs += [(name, r, d, *_launch(d, r, world)) for r in range(world)]

    # the JAX half, while the ranks run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, 'default_backend', lambda: 'tpu')
        for module in (jplan, jpush):
            mp.setattr(module, 'make_fused_step_autoreset', partial(module.make_fused_step_autoreset, interpret=True))
        jax_out = {(f, w): _jax_run(f, w, starts[f], actions[f]) for f in starts for w in (2, 4)}

    failed, out = [], {name: [] for name in RUNS}
    for name, rank, d, proc, log in procs:
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = 'timeout'
        log.close()
        if rc != 0:
            failed.append(f'{name} rank {rank}: {rc}\n' + open(d / f'vector_rank{rank}.log').read()[-3000:])
            continue
        with np.load(d / f'vector_rank{rank}.npz') as z:
            out[name].append(dict(z))
    assert not failed, '\n'.join(failed)
    return SimpleNamespace(jax=jax_out, ranks=out)


@pytest.mark.parametrize('fused', [0, 1])
@pytest.mark.parametrize('family', list(vcases.FAMILIES))
def test_world_size_1_is_the_unsharded_env(runs, family, fused):
    (r0,) = runs.ranks['world1']
    assert bool(r0[f'{family}/fused{fused}/equal'])


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('family', list(vcases.FAMILIES))
def test_mesh_env_matches_jax(runs, family, world):
    ranks = runs.ranks[f'jax{world}']
    want = runs.jax[(family, world)]
    p = family + '/'
    got = {k[len(p):]: v for k, v in ranks[0].items() if k.startswith(p) and not k.startswith(p + 'state.')}
    for other in ranks[1:]:  # every rank returns the global batch
        assert all(np.array_equal(other[p + k], v) for k, v in got.items())
    got.update({k[len(p):]: np.concatenate([r[k] for r in ranks]) for k in ranks[0] if k.startswith(p + 'state.')})
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating) and not k.endswith(('/1', 'reward')):
            tol = TOL_ACC if k in ('state.acc', 'state.act') else TOL
            np.testing.assert_allclose(g, w, **tol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize('fused', [0, 1])
@pytest.mark.parametrize('family', list(vcases.FAMILIES))
def test_each_rank_is_the_unsharded_step_on_its_shard(runs, family, fused):
    ranks = runs.ranks['restarts2']
    key = f'{family}/fused{fused}'
    assert all(bool(r[f'{key}/equal']) for r in ranks)
    assert all(int(r[f'{key}/ends']) > 0 for r in ranks), 'no env restarted'
    assert np.array_equal(ranks[0][f'{key}/obs'], ranks[1][f'{key}/obs'])  # both hold the global batch


@pytest.mark.parametrize('run', ['world1', 'jax2', 'jax4'])
def test_one_collective_a_step(runs, run):
    """Each step makes one collective on every rank, for outputs of several
    dtypes (``[collectives, dtypes]`` a step)."""
    counts = [v for r in runs.ranks[run] for k, v in r.items() if 'collectives' in k.split('/')]
    assert counts and all(len(c) and (c[:, 0] == 1).all() and (c[:, 1] >= 3).all() for c in counts), counts
