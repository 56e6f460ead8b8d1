"""Planning's reset tests its candidate sets in bounded chunks
(``models/planning.reset``, ``RESET_CHUNK_ENTRIES``, ``reset_chunks``).

- With the chunk constant patched down so that a reset of 4 or 6 movers
  (circle and box) runs in 2 to 13 chunks of whole rounds of sets, or in
  chunks of envs as well, the reset is bit-equal to the one-chunk reset on
  the same CPU generator: positions, goals, the first observation,
  ``reset_stalled`` and ``reset_trials``; on tables where some envs stall,
  none do, and every env does.
- A stalled env keeps the last set (``k - 1``) of the uniforms and counts
  ``k`` trials.
- 1-mover resets and the 4-mover default at 4096 envs take one chunk, as
  they did before the chunks; a chunk counts each (set, env)'s mover pairs
  and its movers' table cells.
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import draw_uniforms

B = 48
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make(side: int, m: int, box: bool):
    return tplan.make_planning_env(np.ones((side, side)), m, collision_params=BOX if box else {}, device='cpu')


def reset_counting(monkeypatch, cfg, prm, b, seed):
    """``reset`` of ``b`` envs from a generator seeded ``seed``, and the
    chunks (sets, envs) each sampler ran."""
    calls = []
    real = tplan._first_accepted

    def spy(sets, accept, k, batch, chunk, block):
        calls.append((-(-k // chunk[0]), -(-batch // chunk[1])))
        return real(sets, accept, k, batch, chunk, block)

    monkeypatch.setattr(tplan, '_first_accepted', spy)
    out = tplan.reset(cfg, prm, b, torch.Generator().manual_seed(seed))
    monkeypatch.setattr(tplan, '_first_accepted', real)
    return out, calls


def same(a, b) -> bool:
    (sa, oa, ia), (sb, ob, ib) = a, b
    leaves = [(sa.pos, sb.pos), (sa.goals, sb.goals)] + [(oa[k], ob[k]) for k in oa] + [(ia[k], ib[k]) for k in ia]
    return all(torch.equal(x, y) for x, y in leaves)


def per_set_env(side: int, m: int) -> int:
    return m * (m - 1) // 2 + m * side * side


@pytest.mark.parametrize('split', ['rounds1', 'rounds3', 'rounds6', 'envs20'])
@pytest.mark.parametrize('side,m,box', [(3, 4, False), (3, 4, True), (4, 4, False), (4, 6, False), (4, 6, True),
                                        (3, 6, False)])
def test_chunked_reset_is_bit_equal_to_one_chunk(monkeypatch, side, m, box, split):
    cfg, prm = make(side, m, box)
    monkeypatch.setattr(tplan, 'RESET_CHUNK_ENTRIES', 1 << 40)
    whole, calls = reset_counting(monkeypatch, cfg, prm, B, 5)
    assert calls == [(1, 1), (1, 1)]
    k = 8 * -(-cfg.max_reset_trials // 8)
    if split.startswith('rounds'):  # whole rounds of all B envs
        rounds = int(split[len('rounds'):])
        monkeypatch.setattr(tplan, 'RESET_CHUNK_ENTRIES', rounds * 8 * B * per_set_env(side, m))
        want = (-(-k // (8 * rounds)), 1)
    else:  # one round of 20 envs at a time
        monkeypatch.setattr(tplan, 'RESET_CHUNK_ENTRIES', 8 * 20 * per_set_env(side, m))
        want = (k // 8, -(-B // 20))
    chunked, calls = reset_counting(monkeypatch, cfg, prm, B, 5)
    assert calls == [want] * 2 and 2 <= want[0] * want[1] <= 39
    assert same(chunked, whole)
    stalled = whole[2]['reset_stalled']
    if (side, m) in ((3, 4), (4, 6)):
        assert 0 < int(stalled.sum()) < B  # some envs stall, some do not
    elif (side, m) == (4, 4):
        assert not bool(stalled.any())
    else:
        assert bool(stalled.all())


@pytest.mark.parametrize('rounds', [1, 4])
def test_a_stalled_reset_keeps_the_last_set(monkeypatch, rounds):
    """6 movers on one 3x3 table never fit: every env keeps set k - 1 of the
    uniforms for its starts and for its goals, and counts k trials each."""
    cfg, prm = make(3, 6, False)
    m, k = 6, 8 * -(-cfg.max_reset_trials // 8)
    monkeypatch.setattr(tplan, 'RESET_CHUNK_ENTRIES', rounds * 8 * B * per_set_env(3, 6))
    state, _, info = tplan.reset(cfg, prm, B, torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    lo, hi = prm.min_xy, prm.max_xy
    last = []
    for _ in range(2):  # the starts' uniforms, then the goals'
        u = draw_uniforms(2 * m * k, B, 'cpu', g).to(lo.dtype).reshape(k, m, 2, B).permute(0, 3, 1, 2)
        last.append(torch.maximum(lo, u[k - 1] * (hi - lo) + lo))
    assert bool(info['reset_stalled'].all())
    assert torch.equal(info['reset_trials'], torch.full((B,), 2 * k, dtype=torch.int32))
    assert torch.equal(state.pos, last[0]) and torch.equal(state.goals, last[1])


@pytest.mark.parametrize('m,cells,b,k,block,want', [
    (1, 9, 65536, 100, 1, (100, 65536)),  # one mover on 3x3: one chunk
    (4, 16, 4096, 104, 8, (104, 4096)),  # the 4-mover default: 104 x 4096 x (6 + 64) = 29.8M entries
    (24, 256, 4096, 104, 8, (8, 1306)),  # 24 movers on 16x16: 276 + 6144 entries a set and env
    (24, 256, 65536, 104, 8, (8, 1306)),
    (2, 9, 512, 104, 8, (104, 512)),
])
def test_reset_chunks(m, cells, b, k, block, want):
    assert tplan.reset_chunks(m, cells, b, k, block) == want


@pytest.mark.parametrize('m,side', [(1, 3), (4, 4)])
def test_defaults_take_one_chunk(monkeypatch, m, side):
    """A 1-mover reset and the 4-mover default run their sets as one chunk
    (the 4-mover one at 4096 envs)."""
    cfg, prm = make(side, m, False)
    _, calls = reset_counting(monkeypatch, cfg, prm, 4096 if m > 1 else 512, 3)
    assert calls == [(1, 1), (1, 1)]
