"""The pair schedule of kernel H's many-mover variant, on the CPU.

``planning_multi.pair_schedule`` mirrors the index arithmetic of
``walk_pairs`` in ``csrc/planning_multi.cuh``: the pairs each of the 32
lanes of an env's warp tests, in its order.  For every M the variant takes
(2 to ``MAX_MOVERS``) it must test every pair (i, j), i < j, exactly once,
as (lower, higher), the order the plain version tests it in, and
the lanes' counts must differ by at most one (a warp votes after every pair,
so the longest lane sets the walk).
"""

import functools

import numpy as np
import pytest

from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmulti

MOVERS = range(2, kmulti.MAX_MOVERS + 1)


@functools.lru_cache(maxsize=None)
def schedule(m: int):
    return kmulti.pair_schedule(m)


def test_pair_schedule_covers_every_pair_once():
    for m in MOVERS:
        pairs = np.concatenate(schedule(m))
        assert (pairs[:, 0] < pairs[:, 1]).all() and (pairs >= 0).all() and (pairs < m).all(), m
        keys = np.sort(pairs[:, 0] * m + pairs[:, 1])
        assert len(keys) == m * (m - 1) // 2 and (np.diff(keys) > 0).all(), m


def test_pair_schedule_balances_the_lanes():
    for m in MOVERS:
        counts = [len(lane) for lane in schedule(m)]
        assert len(counts) == 32 and max(counts) - min(counts) <= 1, (m, counts)


@pytest.mark.parametrize('m', [129, 256, 735])
def test_pair_schedule_keeps_a_lane_on_its_rows(m):
    """In the rounds of whole folded rows, a lane's lower mover changes once
    a row (it stays in registers) and its partners step by one, so the 32
    lanes read consecutive records."""
    rounds = (m - 1) // 2 // 32
    for lane, pairs in enumerate(schedule(m)):
        for t in range(rounds):
            row = pairs[t * m:(t + 1) * m]
            a = 32 * t + lane
            assert list(np.unique(row[:, 0])) == [a, m - 2 - a]
            assert (np.diff(row[:, 1])[row[1:, 0] == row[:-1, 0]] == 1).all()
