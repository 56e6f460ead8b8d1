"""Host ms to enqueue one step: the host clock from a call's start to the
end of its enqueue (before the synchronise), summed over the window's
calls, over the window's steps."""


def read(ctx: dict):
    timer = ctx['timer']
    return sum(t_enq - t0 for t0, t_enq, _ in timer) * 1e3 / (len(timer) * ctx['steps_per_call'])
