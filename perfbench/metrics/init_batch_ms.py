"""Host ms of the set-up's ``init_batch`` (the initial batch's reset),
ending in a synchronise."""


def read(ctx: dict):
    return ctx['init_batch_ms']
