"""Kernel launch calls (the runtime's and its driver API's) in the traced
stretch, over its steps."""

import tracing


def read(ctx: dict):
    parsed = ctx['parsed']
    if parsed is None:
        return None
    lo, hi = tracing.window(parsed)
    return tracing.launches_in(parsed, lo, hi) / tracing.traced_env_steps(ctx)
