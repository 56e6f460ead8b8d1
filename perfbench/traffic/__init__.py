"""Traffic: each mix is ``<name>.json``, a file of parameters (batch,
steps a call, steps a launch, the policy's widths) read by the generator
of its ``kind``, ``<kind>.py``: ``open_loop`` (actions drawn ahead for each
call) and ``reactive`` (a policy in the loop)."""
