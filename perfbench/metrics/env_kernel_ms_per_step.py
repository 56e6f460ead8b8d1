"""Device ms of the kernels launched inside the ``env_step`` span (the
program's rollout, less its policy steps), over the traced steps."""

import tracing


def read(ctx: dict):
    parsed = ctx['parsed']
    if parsed is None:
        return None
    busy = tracing.device_seconds(parsed, 'env_step')
    return busy * 1e3 / tracing.traced_env_steps(ctx) if busy > 0 else None
