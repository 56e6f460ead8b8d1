"""The share of the untraced window in which the device ran nothing.

The profiler slows the host, so the traced stretch's own idle share
measures mostly the profiler where the host paces the device.  This takes
from the trace only the device's busy time a call (the union of its
operations, kernels, copies and fills, over the traced window, over the
traced calls) and sets it against the window the end-to-end metrics read:
1 - busy a call x the window's calls / the window's length."""

import stats
import tracing


def read(ctx: dict):
    parsed = ctx['parsed']
    if parsed is None:
        return None
    lo, hi = tracing.window(parsed)
    busy = stats.busy([(s, e) for s, e, *_ in parsed['device']], lo, hi) / len(ctx['traced_counts'])
    return 100.0 * (1.0 - busy * len(ctx['timer']) / ctx['window_s'])
