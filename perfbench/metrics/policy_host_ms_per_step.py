"""Host ms a step of the program's ``gprt.policy`` span (a reactive
rollout's policy step and the clamp of its action), from the span stretch
(``program_trace``)."""

import program_trace


def read(ctx: dict):
    return program_trace.per_step_ms(ctx, program_trace.POLICY)
