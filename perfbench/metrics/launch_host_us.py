"""Host us of one kernel wrapper call: the program's ``gprt.launch`` span
(``ops/kernels.dispatch``, entry to return) over its count, from the span
stretch (``program_trace``)."""

import program_trace


def read(ctx: dict):
    r = program_trace.readings(ctx)
    row = r and r['spans'].get(program_trace.LAUNCH)
    return row['total_ms'] * 1e3 / row['count'] if row else None
