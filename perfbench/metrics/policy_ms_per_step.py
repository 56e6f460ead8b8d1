"""Device ms of the kernels launched inside the benchmark's ``policy``
span (the policy step handed to the reactive rollout), over the traced
steps."""

import tracing


def read(ctx: dict):
    parsed = ctx['parsed']
    if parsed is None:
        return None
    busy = tracing.device_seconds(parsed, 'policy')
    return busy * 1e3 / tracing.traced_env_steps(ctx) if busy > 0 else None
