"""The traffic repeats exactly by seed: the initial batch, each call's
actions or exploration noise, and the policy's weights; another seed
draws other traffic of the same sizes."""

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
import manifest  # noqa: E402
import tracing  # noqa: E402
from traffic import open_loop, reactive  # noqa: E402

CPU = torch.device('cpu')


def driver(cell, seed):
    spec = manifest.cell(manifest.load(), cell)
    mix = dict(spec['mix'], envs=16, steps_per_call=4)
    kind = {'open_loop': open_loop, 'reactive': reactive}[mix['kind']]
    d = kind.Driver(spec['config'], mix, CPU, harness.seeds(seed), tracing.Spans())
    d.setup()
    return d


def snapshot(d):
    state = d.initial[0]
    draws = [d.draw(i) for i in range(3)]
    leaves = [getattr(state, k) for k in ('pos', 'goal' if hasattr(state, 'goal') else 'goals')]
    return leaves + draws + ([d.weights] if hasattr(d, 'weights') else [])


@pytest.mark.parametrize('cell', ['push-reactive-64k', 'plan4-open-k1-64k', 'push-open-k32-4k'])
def test_traffic_repeats_by_seed(cell):
    a, b, c = snapshot(driver(cell, 2**33 + 17)), snapshot(driver(cell, 2**33 + 17)), snapshot(driver(cell, 5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(x.shape == z.shape for x, z in zip(a, c))
    assert not any(torch.equal(x, z) for x, z in zip(a, c))


def test_calls_draw_fresh_seeds_and_actions():
    d = driver('push-open-k32-4k', 3)
    assert d.call_seed(1) - d.call_seed(0) == d.steps
    x0, x1 = d.draw(0), d.draw(1)
    assert not torch.equal(x0, x1)
    a = json.loads((HERE / 'configs' / 'pushing-default.json').read_text())['env']['a_max']
    assert float(x0.abs().max()) <= a


def test_seeds_take_large_values():
    s = harness.seeds(2**31 + 12345)
    assert len(set(s.values())) == len(s) and all(0 <= v < 2**62 for v in s.values())
    with pytest.raises(ValueError):
        harness.seeds(-1)
