"""Host ms a step of the program's ``gprt.rollout`` span less its child
spans (``gprt.launch``, ``gprt.policy``): the rollout loop's own Python
and enqueue, from the span stretch (``program_trace``)."""

import program_trace


def read(ctx: dict):
    return program_trace.per_step_ms(ctx, program_trace.ROLLOUT, 'self_ms')
