"""Candidates (pushing) or candidate sets (planning: start plus goal)
tested per restart run: the program's ``trials`` counter over its
``restarts`` counter, from the span stretch (``program_trace``).  None
where no restart ran or the rollout counts none (the K-step kernels)."""

import program_trace


def read(ctx: dict):
    r = program_trace.readings(ctx)
    if r is None or not r['counters']['restarts']:
        return None
    return r['counters']['trials'] / r['counters']['restarts']
