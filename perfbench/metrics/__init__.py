"""Per-layer metrics: ``<name>.py`` reads one from a run's context with
``read(ctx)`` and returns a number, or None where the run holds nothing to
read it from (then the result line leaves the metric out).  The context:
``timer`` (each window call's host start, enqueue end and readback end),
``window_s`` (the window's length, ending on its last call's synchronise),
``parsed`` (the traced stretch, ``tracing.parse``; None without records),
``traced_counts`` (each traced call's reward sum, finished and collided
env-steps), ``init_batch_ms``, ``kernel_load_s``, ``costs``, ``peaks``,
``mix``, ``config``, ``steps_per_call``, ``envs``."""
