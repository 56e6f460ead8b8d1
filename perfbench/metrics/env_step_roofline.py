"""The least time the traced stretch's counted env-step work could take at
the card's published peaks, as a share of the device time of the env-step
kernels (``env_step`` span).

The work (``costs/<config>.json``, frozen): every env-step's control
cycles, observations and flags; a collided env-step (reward -50) counts
one cycle, the least its latch allows; each finished env-step one restart
candidate (set), the least a restart needs; a reactive step its feature
blocks.  Bytes: the state read and written once a call, each step's
action, reward and flags (and feature blocks).  The least time is the
largest of f32 operations, special functions and bytes over their peaks."""

import tracing


def read(ctx: dict):
    parsed = ctx['parsed']
    if parsed is None:
        return None
    busy = tracing.device_seconds(parsed, 'env_step')
    if busy <= 0:
        return None
    c, peaks, mix = ctx['costs'], ctx['peaks'], ctx['mix']
    steps = tracing.traced_env_steps(ctx) * ctx['envs']
    done = sum(x[1] for x in ctx['traced_counts'])
    latched = sum(x[2] for x in ctx['traced_counts'])
    reactive = mix['kind'] == 'reactive'
    n = c['num_cycles']

    def count(kind):
        per_step = n * c['cycle'][kind] + c['step'][kind] + (c['features'][kind] if reactive else 0)
        return steps * per_step - latched * (n - 1) * c['cycle'][kind] + done * c['restart'][kind]

    b = c['bytes']
    nbytes = steps * (2 * b['state'] / ctx['steps_per_call'] + b['action'] + b['signals']
                      + (b['features'] if reactive else 0))
    least = max(count('f32') / peaks['f32_per_s'], count('special') / peaks['special_per_s'],
                nbytes / peaks['bytes_per_s'])
    return 100.0 * least / busy
