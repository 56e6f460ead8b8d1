"""The adapters' card-facing runners (``envs/runner.py``) on the card.

Every test needs a CUDA device (``gpu`` marker) and skips without one.  This
module imports no JAX, gymnasium or pettingzoo (the card's machine has
none):

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_adapters_gpu.py -q

The vector runner takes the fused autoreset step on the card (kernel C and
C box for pushing, F for one mover, H for 4 and, in its many-mover variant,
129 movers) at one launch and one host synchronisation a step (the runner's
event wait; sync debug mode sees no other), and its outputs equal the fused
step called directly under the same generator bit for bit, across the
restarts of 60 steps.  The single-env runner steps eagerly: kernel A draws
its observation noise, one host synchronisation a step.
"""

import warnings

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.envs import runner
from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu

B = 1024 + 33
#: name -> (family, make kwargs, kernel launch counter)
VECTOR = {
    'pushing': (tpush, {}, 'pushing_autoreset'),
    'pushing_box': (tpush, {'collision_params': {'shape': 'box', 'size': [0.09, 0.09]}}, 'pushing_autoreset_box'),
    'planning_m1': (tplan, {'layout_tiles': np.ones((3, 3)), 'num_movers': 1}, 'planning_autoreset'),
    'planning_m4': (tplan, {'layout_tiles': np.ones((4, 4)), 'num_movers': 4}, 'planning_multi_autoreset'),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def make(family, kw, device):
    kw = dict(kw)
    if family is tpush:
        return tpush.make_pushing_env(device=device, **kw)
    return tplan.make_planning_env(kw.pop('layout_tiles'), kw.pop('num_movers'), device=device, **kw)


def sync_calls(fn):
    """(result, synchronising calls) of ``fn()`` under sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum('called a synchronizing' in str(w.message) for w in caught)


def flat(tree):
    return [t for t in runner.leaves(tree, []) if isinstance(t, (torch.Tensor, np.ndarray))]


@pytest.mark.parametrize('name', sorted(VECTOR))
def test_vector_runner_takes_the_fused_step(cuda, name):
    family, kw, counter = VECTOR[name]
    cfg, prm = make(family, kw, cuda)
    assert runner.fused_covers(cfg, prm)
    vr = runner.VectorRunner(cfg, prm, B)
    assert vr.using_fused
    vr.seed(3)
    vr.reset()
    # the fused step called directly, from the same state and generator state
    direct = family.make_fused_step_autoreset(cfg, prm)
    g = torch.Generator(device=cuda)
    g.set_state(vr.generator.get_state())
    state = type(vr.state)(**{k: v.clone() for k, v in vars(vr.state).items()})
    rng = np.random.default_rng(0)
    limit = float(prm.j_max if cfg.learn_jerk else prm.a_max)
    restarts = 0
    for t in range(60):
        acts = rng.uniform(-limit, limit, (B, 2 * getattr(cfg, 'num_movers', 1))).astype(np.float32)
        kernels.reset_launches()
        syncs_before = vr.host.host_syncs
        host_out, calls = sync_calls(lambda: vr.step(acts))
        assert vr.host.host_syncs == syncs_before + 1 and calls == 0, (t, calls)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert launches == {counter: 1}, launches
        state, *dev_out = direct(state, torch.from_numpy(acts).to(cuda), generator=g)
        got, want = flat(host_out), [t_.cpu().numpy() for t_ in flat(tuple(dev_out))]
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want)), t
        restarts += int(host_out[2].sum() + host_out[3].sum())
    for k, v in vars(vr.state).items():
        assert torch.equal(v, getattr(state, k)), k
    assert restarts > 0


def test_vector_runner_many_movers(cuda):
    """129 movers from the slots of a 22x22 table: the vector runner takes
    kernel H's many-mover variant, one launch a step."""
    m, b = 129, 64
    cfg, prm = tplan.make_planning_env(np.ones((22, 22)), m, device=cuda)
    vr = runner.VectorRunner(cfg, prm, b)
    assert vr.using_fused
    slots = [(0.3 + 0.42 * i, 0.3 + 0.42 * j) for i in range(12) for j in range(12)][:m]
    vr.state = tplan.reset(cfg, prm, b, vr.generator, start_xy=slots, goals_xy=slots[::-1])[0]
    kernels.reset_launches()
    for _ in range(3):
        out = vr.step(np.zeros((b, 2 * m), np.float32))
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {'planning_multi_autoreset_many': 3}
    assert out[0]['observation'].shape == (b, 2 * m) and np.isfinite(out[0]['observation']).all()


@pytest.mark.parametrize('name', ['pushing', 'planning_m1', 'planning_m4'])
def test_env_runner_steps_eagerly_with_one_sync(cuda, name):
    """The single-env runner: kernel A draws the observation noise (no other
    kernel runs), one host synchronisation a step, and the eager step itself
    makes no other."""
    family, kw, _ = VECTOR[name]
    cfg, prm = make(family, kw, cuda)
    er = runner.EnvRunner(cfg, prm)
    er.seed(1)
    er.reset()
    n = 2 * getattr(cfg, 'num_movers', 1)
    for t in range(5):
        kernels.reset_launches()
        before = er.host.host_syncs
        out, calls = sync_calls(lambda: er.step(np.full(n, 0.5)))
        assert er.host.host_syncs == before + 1 and calls == 0, (t, calls)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        assert set(launches) == {'noise_probe'}, launches
        assert np.isfinite(out[0]['observation']).all() and out[0]['observation'].ndim == 1
