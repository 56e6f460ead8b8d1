"""Port parity: ``utils/checkpoint.py`` against the JAX package's.

Both save and restore the learner's weights bit for bit (the JAX package's
HER params pytree, and the port's networks carrying the same weights); the
port's also round-trips what a PyTorch runner holds besides arrays (state
dataclasses, ``nn.Module``s, optimizers, generators, dicts with int keys,
host ints) through one ``torch.save`` file, and a HER run resumed from a checkpoint equals the run that was
not interrupted, bit for bit (the CPU: the plain kernels, deterministic).
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from gymnasium_planar_robotics_tpu.models import her as jher
from gymnasium_planar_robotics_tpu.utils import checkpoint as jckpt
from gymnasium_planar_robotics_tpu_torch.models import her as ther
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.utils import checkpoint as tckpt

CFG = ther.HERConfig(obs_dim=2, goal_dim=2, action_dim=2, hidden=(16, 16), rollout_steps=3, update_steps=2,
                     replay_size=1024, minibatch=64, twin_critic=True, target_noise=0.1, policy_delay=2)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def her_runner(seed=0, b=8):
    """A HER runner on small 1-mover planning over the fused step (the
    plain kernel F here), with its train step."""
    cfg, prm = tplan.make_planning_env(np.ones((3, 3)), 1, num_cycles=4, device='cpu')
    g = torch.Generator().manual_seed(seed)
    fused = tplan.make_fused_step_autoreset(cfg, prm)
    step, make_opts = ther.make_train_step(
        cfg, prm, CFG, None, lambda ach, des, mc, wc: tplan.compute_reward(cfg, prm, ach, des, mc, wc),
        lambda r: torch.abs(r) == 50.0, batched_step_fn=lambda s, a: fused(s, a, generator=g))
    state, obs, _ = tplan.init_batch(cfg, prm, b, g)
    nets = ther.init_params(CFG, g, device='cpu')
    return step, (state, obs, nets, *make_opts(nets), ther.init_replay(CFG, device='cpu'), g)


def assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, (torch.nn.Module, torch.optim.Optimizer)):
        assert_trees_equal(a.state_dict(), b.state_dict())
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            assert_trees_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert a == b


def test_her_params_round_trip_as_in_jax(tmp_path):
    """The JAX package's checkpoint of a twin-critic HER params pytree and
    the port's of the same weights restore to the same arrays, bit for bit,
    with the step recorded."""
    cfg = jher.HERConfig(obs_dim=2, goal_dim=2, action_dim=2, hidden=(16, 16), twin_critic=True)
    jpar = jher.init_params(jax.random.PRNGKey(0), cfg)
    jckpt.save(tmp_path / 'jax', jpar, step=7)
    nets = ther.params_from_numpy(jax.tree_util.tree_map(np.asarray, jpar), device='cpu')
    tckpt.save(tmp_path / 'torch', nets, step=7)
    jback = jckpt.restore(tmp_path / 'jax', jher.init_params(jax.random.PRNGKey(1), cfg))
    tback = tckpt.restore(tmp_path / 'torch', ther.init_params(ther.HERConfig(**dataclasses.asdict(cfg)),
                                                               torch.Generator().manual_seed(1), device='cpu'))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jback)]
    got = [np.asarray(x) for x in jax.tree_util.tree_leaves(ther.params_to_numpy(tback))]
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert tckpt.saved_step(tmp_path / 'torch') == jckpt.saved_step(tmp_path / 'jax') == 7


def test_runner_round_trip_is_exact(tmp_path):
    """A HER runner after two iterations (env state dataclass, observation
    dict, networks, both Adam states, the replay buffer with its host ints,
    the generator) and odd leaves (f64, int, bool tensors, a dict with int
    keys, a tuple, None) restore bit for bit into a fresh runner; a
    template of another structure raises."""
    step, runner = her_runner()
    for _ in range(2):
        runner, _ = step(runner)
    extra = {'f64': torch.linspace(0, 1, 7, dtype=torch.float64), 'i32': torch.arange(5, dtype=torch.int32),
             'flags': torch.tensor([True, False]), 'by_int': {3: 1.5, 4: None}, 'pair': (2, 'x')}
    tckpt.save(tmp_path, {'runner': runner, 'extra': extra}, step=2)
    _, fresh = her_runner(seed=5)
    like = {'runner': fresh, 'extra': {**extra, 'f64': torch.zeros(7, dtype=torch.float64)}}
    back = tckpt.restore(tmp_path, like)
    assert back['runner'][2] is fresh[2] and back['runner'][6] is fresh[6]  # loaded in place
    assert_trees_equal(back['runner'], runner)
    assert_trees_equal(back['extra'], extra)
    assert tckpt.saved_step(tmp_path) == 2
    with pytest.raises(ValueError, match='structure mismatch'):
        tckpt.restore(tmp_path, {'runner': fresh[:-1], 'extra': extra})
    with pytest.raises(ValueError, match='structure mismatch'):
        tckpt.restore(tmp_path, {'runner': fresh, 'extra': {**extra, 'f64': torch.zeros(7)}})


def test_resume_equals_uninterrupted(tmp_path):
    """Three iterations in one go against two, a checkpoint, a restore into
    a fresh runner and one more: the third iteration's metrics and every
    weight, moment and buffer row equal bit for bit."""
    step, runner = her_runner()
    for _ in range(3):
        runner, m_full = step(runner)
    step2, part = her_runner()
    for _ in range(2):
        part, _ = step2(part)
    tckpt.save(tmp_path, part, step=2)
    step3, fresh = her_runner(seed=9)
    resumed = tckpt.restore(tmp_path, fresh)
    resumed, m_resumed = step3(resumed)
    for k in m_full:
        assert torch.equal(m_full[k], m_resumed[k]), k
    assert_trees_equal(resumed, runner)
