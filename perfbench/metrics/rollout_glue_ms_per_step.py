"""Device ms a step of the operations launched inside the program's
``gprt.rollout`` span but outside its ``gprt.launch`` and ``gprt.policy``
spans (the rollout loop's own clamps, stacks and reward ops), from the
profiled stretch of ``program_trace``."""

import program_trace


def read(ctx: dict):
    r = program_trace.readings(ctx)
    if r is None or r['glue_device_s'] is None:
        return None
    return r['glue_device_s'] * 1e3 / r['steps']
