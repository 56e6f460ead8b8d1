"""The 95th percentile of the window's call latencies (ms), in a cell whose
host paces the device: there the tail swings with the host's speed from
run to run, so it stands beside the rate, which is the end-to-end metric."""

import stats


def read(ctx: dict):
    return stats.percentile([(t1 - t0) * 1e3 for t0, _, t1 in ctx['timer']], 95.0)
