"""The benchmark's arithmetic: percentiles, and the union of device
intervals with the gaps between them."""

from __future__ import annotations

import math


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, interpolated between
    the two nearest ranks (numpy's default, 'linear')."""
    xs = sorted(values)
    if not xs:
        raise ValueError('no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: list) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals: list, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals: list, lo: float, hi: float) -> float:
    """The length of ``[lo, hi]`` that the intervals cover."""
    return sum(e - s for s, e in clip(union(intervals), lo, hi))


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The ``(start, end)`` stretches of ``[lo, hi]`` no interval covers."""
    out, t = [], lo
    for s, e in clip(union(intervals), lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
