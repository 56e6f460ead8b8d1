"""The port's Gymnasium, vector and PettingZoo adapters against the JAX
package's, on the CPU (``device='cpu'``).

Both sides are built with the same explicit dtype (float64: the suite turns
on x64) and ``std_noise=0``, so the noise cannot matter; both start from the
same planted state (reset options where they fix it, else the state
converters) and take the same numpy actions from a seed.  Then obs, reward,
terminated, truncated and info are held step by step at the float64
tolerances of ``tests/test_torch_planning_step.py`` and
``tests/test_torch_pushing_step.py`` (rtol 1e-9 / atol 1e-9; observations
that hold accelerations atol 1e-8), flags and rewards exactly; the HER
``compute_*`` functions on arrays of info dicts; the vector envs through the
truncation at step 50 with ``final_observation``; PettingZoo's per-agent
rewards, terminations and truncations; and the 2D ``rgb_array_2d`` frame of
the same state pixel for pixel.  Gymnasium's ``check_env`` and PettingZoo's
``parallel_api_test`` run on the port's envs, and the port's registry ids
stand beside the JAX package's.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import gymnasium as gym
import jax.numpy as jnp
import torch

import gymnasium_planar_robotics_tpu  # noqa: F401  (registers the JAX package's ids)
from gymnasium_planar_robotics_tpu.envs import gym_env as jgym
from gymnasium_planar_robotics_tpu.envs import pettingzoo_env as jpz
from gymnasium_planar_robotics_tpu.envs import vector_env as jvec
from gymnasium_planar_robotics_tpu.envs.registration import register_gymnasium_envs as register_jax_envs
from gymnasium_planar_robotics_tpu.models import planning as jplan
from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu_torch.envs import gym_env as tgym
from gymnasium_planar_robotics_tpu_torch.envs import pettingzoo_env as tpz
from gymnasium_planar_robotics_tpu_torch.envs import registration
from gymnasium_planar_robotics_tpu_torch.envs import vector_env as tvec
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush

TOL = dict(rtol=1e-9, atol=1e-9)
TOL_ACC = dict(rtol=1e-9, atol=1e-8)
F64 = dict(std_noise=0.0)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_tree(got, want, path=''):
    """Nested dicts of arrays and scalars: floats at TOL (TOL_ACC for an
    observation that holds accelerations), the rest exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree(got[k], want[k], f'{path}.{k}')
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        tol = TOL_ACC if path.endswith('observation') else TOL
        np.testing.assert_allclose(g, w, **tol, err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


def plant_single(jenv, tenv, family, d: dict):
    """The same state (numpy leaves with a batch axis of 1) in both
    single-env adapters."""
    tenv._state = family[1].state_from_numpy(d, device='cpu')
    jenv._state = type(jenv._state)(**{k: jnp.asarray(v[0]) for k, v in d.items()}, key=jenv._state.key)


def _planning_state(m: int, rng, b: int = 1) -> dict:
    """Movers on a row 0.3 m apart on the 4x4 table, mover 0 moving toward
    the -x wall, movers 1 and 2 head-on (so the runs see both collisions);
    goals away from the starts; all float64."""
    pos = np.array([[0.2 + 0.3 * i, 0.5] for i in range(m)])[None].repeat(b, 0) + rng.uniform(-0.01, 0.01, (b, m, 2))
    vel = np.zeros((b, m, 2))
    vel[:, 0] = [-0.6, 0.05]
    if m >= 3:
        vel[:, 1], vel[:, 2] = [0.9, 0.0], [-0.9, 0.0]
    goals = pos + np.array([0.0, 0.3])
    z = np.zeros((b, m, 2))
    return dict(pos=pos, vel=vel, acc=z, act=z.copy(), goals=goals, steps=np.zeros(b, np.int32))


def _pushing_state(rng, b: int = 1) -> dict:
    """The mover at the object's -x face moving toward it, the goal across
    the table; all float64."""
    obj = np.array([[0.36, 0.36]]).repeat(b, 0) + rng.uniform(-0.02, 0.02, (b, 2))
    z = np.zeros((b, 2))
    return dict(pos=obj + [-0.115, 0.0], vel=z + [0.4, 0.0], acc=z.copy(), act=z.copy(), obj_pos=obj, obj_vel=z.copy(),
                obj_yaw=np.zeros(b), obj_w=np.zeros(b), mover_z=np.full(b, 0.003), mover_vz=np.zeros(b),
                goal=np.array([[0.55, 0.2]]).repeat(b, 0), steps=np.zeros(b, np.int32))


SINGLE = {
    'planning_m1': (1, {}),
    'planning_m3': (3, {'layout_tiles': np.ones((4, 4))}),
    'planning_m3_box_jerk': (3, {'layout_tiles': np.ones((4, 4)), 'learn_jerk': True,
                                 'collision_params': {'shape': 'box', 'size': [0.09, 0.08]}}),
    'pushing': (0, {}),
}


def zero_object_noise(jenv, tenv):
    """Pushing's object observation noise (a constant of the params, not
    ``std_noise``) set to 0 on both sides, the JAX step rebuilt over it."""
    import dataclasses

    import jax

    jenv.params = dataclasses.replace(jenv.params, object_noise=jnp.zeros_like(jenv.params.object_noise))
    tenv.params = tenv._runner.params = dataclasses.replace(tenv.params,
                                                            object_noise=torch.zeros_like(tenv.params.object_noise))
    cfg, prm = jenv.config, jenv.params
    if isinstance(jenv, jvec._JaxVectorEnv):
        step = jax.vmap(jpush.step_autoreset, in_axes=(None, None, 0, 0))
        jenv._step_jit = jax.jit(lambda st, a: step(cfg, prm, st, a))
    else:
        jenv._step_jit = jax.jit(lambda st, a: jpush.step(cfg, prm, st, a))


def make_single(name, **kw):
    m, extra = SINGLE[name]
    extra = dict(extra, **F64, **kw)
    if m == 0:
        jenv, tenv = jgym.PushingGymEnv(dtype=jnp.float64, **extra), tgym.PushingGymEnv(dtype=torch.float64,
                                                                                        device='cpu', **extra)
        zero_object_noise(jenv, tenv)
        return jenv, tenv, (jpush, tpush)
    return (jgym.PlanningGymEnv(num_movers=m, dtype=jnp.float64, **extra),
            tgym.PlanningGymEnv(num_movers=m, dtype=torch.float64, device='cpu', **extra), (jplan, tplan))


@pytest.mark.parametrize('name', sorted(SINGLE))
def test_gym_env_matches_jax(name):
    """Spaces, the reset with overrides, then 12 steps of the same actions:
    every output equal within the tolerances; the name-keyed accessors and
    their noise stream equal too."""
    jenv, tenv, family = make_single(name)
    assert jenv.observation_space == tenv.observation_space and jenv.action_space == tenv.action_space
    rng = np.random.default_rng(11)
    pushing = name == 'pushing'
    d = _pushing_state(rng) if pushing else _planning_state(SINGLE[name][0], rng)
    opts = ({'mover_start_xy_pos': d['pos'][0], 'object_goal_xy_pos': d['goal'][0]} if pushing else
            {'mover_start_xy_pos': d['pos'][0], 'mover_goal_xy_pos': d['goals'][0]})
    (jo, ji), (to, ti) = jenv.reset(seed=3, options=opts), tenv.reset(seed=3, options=opts)
    if not pushing:  # the object start is drawn by each side's own generator
        assert_tree(to, jo)
        assert_tree(ti, ji)
    plant_single(jenv, tenv, family, d)
    acts = rng.uniform(-1.0, 1.0, (12,) + tenv.action_space.shape) * tenv.action_space.high
    events = set()
    for t, a in enumerate(acts):
        jout, tout = jenv.step(a), tenv.step(a)
        for k, (g, w) in enumerate(zip(tout, jout)):
            assert type(g) is type(w), (t, k, type(g), type(w))
            assert_tree(g, w, f'step {t} out {k}')
        events |= {k for k in ('wall_collision', 'mover_collision', 'is_success') if tout[4][k]}
        if tout[2]:
            break
    if pushing:  # the mover pushed the object
        assert np.abs(np.asarray(tenv._state.obj_pos)[0] - d['obj_pos'][0]).max() > 1e-3
    else:
        assert events & {'wall_collision', 'mover_collision'}, events
    for mover in tenv.mover_names:
        for fn in ('get_mover_qpos', 'get_mover_qvel', 'get_mover_qacc'):
            for noisy in (False, True):
                np.testing.assert_allclose(getattr(tenv, fn)(mover, noisy), getattr(jenv, fn)(mover, noisy), **TOL)
    jenv.close()
    tenv.close()


def test_gym_env_clips_with_a_warning_and_seeds():
    """An action outside the box is clipped with Gymnasium's warning, as the
    JAX adapter does; a seeded reset repeats, an unseeded one continues the
    stream."""
    jenv, tenv, _ = make_single('planning_m1')
    tenv.reset(seed=5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        tenv.step(np.array([100.0, 0.0]))
    assert any('will be clipped' in str(w.message) for w in caught)
    a = tenv.reset(seed=9)[0]
    b = tenv.reset()[0]
    c = tenv.reset(seed=9)[0]
    assert_tree(c, a)
    assert not np.array_equal(a['achieved_goal'], b['achieved_goal'])


HER_INFOS = [{'mover_collision': m, 'wall_collision': w, 'is_success': False}
             for m, w in ((False, False), (True, False), (False, True), (False, False), (False, False), (True, True))]


@pytest.mark.parametrize('name', ['planning_m3', 'pushing'])
def test_her_compute_functions_match_jax(name):
    """compute_reward / compute_terminated / compute_truncated on a batch
    with an array of info dicts, and on one sample with one info dict."""
    jenv, tenv, _ = make_single(name)
    width = tenv.observation_space['achieved_goal'].shape[0]
    rng = np.random.default_rng(2)
    ag = rng.uniform(0.1, 0.6, (6, width))
    dg = ag + rng.normal(0.0, 0.08, (6, width))
    dg[3] = ag[3]  # a reached goal
    infos = np.array(HER_INFOS)
    for fn in ('compute_reward', 'compute_terminated', 'compute_truncated'):
        got, want = getattr(tenv, fn)(ag, dg, infos), getattr(jenv, fn)(ag, dg, infos)
        np.testing.assert_array_equal(got, want, err_msg=fn)
        assert got.shape == (6,)
        for i in (0, 3, 5):
            one, ref = getattr(tenv, fn)(ag[i], dg[i], HER_INFOS[i]), getattr(jenv, fn)(ag[i], dg[i], HER_INFOS[i])
            assert type(one) is type(ref) and one == ref, (fn, i)


@pytest.mark.parametrize('family', ['planning', 'pushing'])
def test_vector_env_matches_jax_through_truncation(family):
    """4 envs from the same planted states with small actions (no
    collision): 50 steps equal, the 50th truncating every env with
    ``final_observation`` equal; the restarts (each side's generator) are
    fresh episodes of the right shapes."""
    b = 4
    if family == 'planning':
        kw = dict(num_movers=1, layout_tiles=np.ones((3, 3)), **F64)
        jv, tv = jvec.PlanningVectorEnv(b, dtype=jnp.float64, **kw), tvec.PlanningVectorEnv(b, dtype=torch.float64,
                                                                                               device='cpu', **kw)
        d = dict(pos=np.array([[[0.3, 0.3]], [[0.35, 0.4]], [[0.4, 0.3]], [[0.3, 0.35]]]), vel=np.zeros((b, 1, 2)),
                 acc=np.zeros((b, 1, 2)), act=np.zeros((b, 1, 2)), goals=np.full((b, 1, 2), 0.6),
                 steps=np.zeros(b, np.int32))
        conv = tplan
    else:
        jv, tv = jvec.PushingVectorEnv(b, dtype=jnp.float64, **F64), tvec.PushingVectorEnv(b, dtype=torch.float64,
                                                                                            device='cpu', **F64)
        zero_object_noise(jv, tv)
        d = _pushing_state(np.random.default_rng(1), b)
        d['vel'][:] = 0.0
        conv = tpush
    assert not tv.using_fused  # the CPU steps eagerly, as the JAX package off its accelerator
    assert jv.single_observation_space == tv.single_observation_space
    assert jv.single_action_space == tv.single_action_space
    jv.reset(seed=0)
    tv.reset(seed=0)
    tv._runner.state = conv.state_from_numpy(d, device='cpu')
    jv._state = type(jv._state)(**{k: jnp.asarray(v) for k, v in d.items()}, key=jv._state.key)
    rng = np.random.default_rng(4)
    for t in range(50):
        a = rng.uniform(-0.05, 0.05, (b,) + tv.single_action_space.shape)
        jout, tout = jv.step(a), tv.step(a)
        if t < 49:
            for k, (g, w) in enumerate(zip(tout, jout)):
                assert_tree(g, w, f'step {t} out {k}')
            assert not tout[2].any() and not tout[3].any()
    assert tout[3].all() and jout[3].all() and not tout[2].any()
    for k in (1, 2, 3):
        assert_tree(tout[k], jout[k], f'step 50 out {k}')
    assert_tree(tout[4]['final_observation'], jout[4]['final_observation'], 'final_observation')
    assert set(tout[4]) == set(jout[4])
    assert np.asarray(tv._runner.state.steps).tolist() == [0] * b
    for k, v in tout[0].items():
        assert v.shape == jout[0][k].shape and np.isfinite(v).all()
    jv.close()
    tv.close()


def test_vector_env_mesh_not_ported():
    """The mesh is ported (``tests/test_torch_vector_env_mesh.py``); for
    both vector envs a batch that does not split into the mesh's equal
    shards raises, as the JAX package's ``NamedSharding`` does."""
    mesh = SimpleNamespace(size=lambda: 2, get_local_rank=lambda: 0, device_type='cpu')
    for cls in (tvec.PlanningVectorEnv, tvec.PushingVectorEnv):
        with pytest.raises(ValueError, match='NamedSharding'):
            cls(7, mesh=mesh, device='cpu')


def test_parallel_env_matches_jax():
    """Three agents from the same planted state (movers 1 and 2 head-on):
    per-agent observations, rewards, terminations, truncations and infos
    equal at every step up to the collision that ends the episode."""
    kw = dict(num_movers=3, layout_tiles=np.ones((4, 4)), **F64)
    jp, tp = jpz.PlanningParallelEnv(dtype=jnp.float64, **kw), tpz.PlanningParallelEnv(dtype=torch.float64,
                                                                                       device='cpu', **kw)
    jp.reset(seed=1)
    tp.reset(seed=1)
    d = _planning_state(3, np.random.default_rng(8))
    d['vel'][:, 0] = 0.0
    tp._runner.state = tplan.state_from_numpy(d, device='cpu')
    jp._state = type(jp._state)(**{k: jnp.asarray(v[0]) for k, v in d.items()}, key=jp._state.key)
    rng = np.random.default_rng(5)
    for t in range(30):
        acts = {a: rng.uniform(-1.0, 1.0, 2) for a in tp.possible_agents}
        jout, tout = jp.step(acts), tp.step(acts)
        for k, (g, w) in enumerate(zip(tout, jout)):
            assert_tree(g, w, f'step {t} out {k}')
        if not tp.agents:
            break
    assert not jp.agents and tout[4]['mover_0']['mover_collision'] and tout[1]['mover_0'] == -50.0
    # a second episode at rest with small actions: truncated at max_episode_steps on both sides
    jp.reset(seed=2)
    tp.reset(seed=2)
    d['vel'][:] = 0.0
    tp._runner.state = tplan.state_from_numpy(d, device='cpu')
    jp._state = type(jp._state)(**{k: jnp.asarray(v[0]) for k, v in d.items()}, key=jp._state.key)
    for t in range(tp.config.max_episode_steps):
        acts = {a: rng.uniform(-0.02, 0.02, 2) for a in tp.possible_agents}
        jout, tout = jp.step(acts), tp.step(acts)
        for k, (g, w) in enumerate(zip(tout, jout)):
            assert_tree(g, w, f'episode 2 step {t} out {k}')
    assert all(tout[3].values()) and not any(tout[2].values()) and not tp.agents and not jp.agents


@pytest.mark.parametrize('name', ['planning_m3', 'pushing'])
def test_rgb_array_2d_frame_matches_jax(name):
    """The top-down frame of the same state, pixel for pixel."""
    jenv, tenv, family = make_single(name, render_mode='rgb_array_2d')
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    rng = np.random.default_rng(6)
    plant_single(jenv, tenv, family, _pushing_state(rng) if name == 'pushing' else _planning_state(3, rng))
    got, want = tenv.render(), jenv.render()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    jenv.close()
    tenv.close()


def test_render_every_cycle_replays_the_cycles():
    """With render_every_cycle, a step renders each of its cycles (the state
    swapped in) and then the final state, which it restores."""
    env = tgym.PlanningGymEnv(num_cycles=6, render_mode='rgb_array_2d', render_every_cycle=True, device='cpu')
    env.reset(seed=0)
    seen, orig = [], env.render
    env.render = lambda: (seen.append(np.asarray(env._state.pos)[0, 0].copy()), orig())[1]
    env.step(np.array([5.0, 0.0]))
    xs = np.asarray(seen)[:, 0]
    assert len(seen) == 7 and (np.diff(xs[:6]) > 0).all()
    np.testing.assert_allclose(xs[5], xs[6])
    env.close()


def test_official_checkers():
    """Gymnasium's check_env on both single envs and PettingZoo's
    parallel_api_test on the parallel env."""
    from gymnasium.utils.env_checker import check_env
    from pettingzoo.test import parallel_api_test

    for env in (tgym.PlanningGymEnv(num_movers=1, device='cpu'), tgym.PushingGymEnv(device='cpu')):
        check_env(env, skip_render_check=True)
        env.close()
    parallel_api_test(tpz.PlanningParallelEnv(num_movers=2, device='cpu', num_cycles=8), num_cycles=60)


def test_registry_ids_stand_beside_the_jax_ids():
    """``register_gymnasium_envs`` adds the port's namespaced ids with the
    50-step limit; the JAX package's ids still make its own classes."""
    register_jax_envs(force=True)
    registration.register_gymnasium_envs()
    registration.register_gymnasium_envs()  # idempotent
    for env_id, cls in ((registration.PLANNING_ID, tgym.PlanningGymEnv), (registration.PUSHING_ID, tgym.PushingGymEnv)):
        env = gym.make(env_id, device='cpu', num_cycles=4)
        assert type(env.unwrapped) is cls and env.spec.max_episode_steps == 50
        env.close()
    for env_id, cls in (('BenchmarkPlanningEnv-v0', jgym.PlanningGymEnv), ('BenchmarkPushingEnv-v0', jgym.PushingGymEnv)):
        env = gym.make(env_id, num_cycles=4)
        assert type(env.unwrapped) is cls
        env.close()


def test_package_surface():
    """The package's lazy names give the adapters' and viewers' classes."""
    import gymnasium_planar_robotics_tpu_torch as pkg
    from gymnasium_planar_robotics_tpu_torch.utils import mujoco_viewer, rendering

    assert pkg.PlanningGymEnv is tgym.PlanningGymEnv and pkg.PushingVectorEnv is tvec.PushingVectorEnv
    assert pkg.PlanningParallelEnv is tpz.PlanningParallelEnv and pkg.Planar2DViewer is rendering.Planar2DViewer
    assert pkg.Matplotlib2DViewer is rendering.Planar2DViewer
    assert pkg.MujocoViewerCollection is mujoco_viewer.MujocoViewerCollection
    from gymnasium_planar_robotics_tpu_torch import core

    assert pkg.BasicPlanarRoboticsEnv is core.PlanarRoboticsCore  # the facade, ported since
    with pytest.raises(AttributeError):
        pkg.NoSuchEnv


@pytest.mark.parametrize('name', ['planning_m3_box_jerk', 'pushing'])
def test_scene_export_and_mirror_match_jax(name):
    """The MJCF scene of the same params is the JAX package's string, and
    the 3D mirror model holds the same qpos after the same state is
    streamed into it (no GL needed: no frame is rendered)."""
    pytest.importorskip('mujoco')
    from gymnasium_planar_robotics_tpu.utils import mujoco_viewer as jmv
    from gymnasium_planar_robotics_tpu.utils import scene_export as jse
    from gymnasium_planar_robotics_tpu_torch.utils import mujoco_viewer as tmv
    from gymnasium_planar_robotics_tpu_torch.utils import scene_export as tse

    jenv, tenv, family = make_single(name)
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    rng = np.random.default_rng(9)
    plant_single(jenv, tenv, family, _pushing_state(rng) if name == 'pushing' else _planning_state(3, rng))
    assert tse.export_scene_xml(tenv.params) == jse.export_scene_xml(jenv.params)
    m = getattr(tenv.config, 'num_movers', 1)
    tv, jv = tmv.MujocoViewerCollection(tenv.params, num_movers=m), jmv.MujocoViewerCollection(jenv.params, num_movers=m)
    tv.update(tenv._state)
    jv.update(jenv._state)
    np.testing.assert_allclose(tv.data.qpos, jv.data.qpos, **TOL)
    np.testing.assert_allclose(tv.model.site_pos, jv.model.site_pos, **TOL)
