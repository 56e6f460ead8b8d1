"""What decides ``correct``: the program's outputs of the checked calls held
against the plain reference, and the trace's breakdown.

The reference starts each checked call from the state the program handed
into it (the program's own state, read from its fields), with the call's
inputs (actions or exploration noise, the Philox seed, the policy's
weights), and works out the whole call again.  The initial state, which
the first checked call starts from, is held to the configuration's start
rules by itself (``start``).

Numbers compared (each against its cell's limit):

- ``start_invalid``: envs of the initial state that break the start rules
  (an exact count, limit 0);
- ``env_diverged``: the share of the batch in which any step's reward,
  termination or truncation differs from the reference's, or a final state
  plane or (reactive) a feature departs by more than ``tolerance * (1 +
  |reference|)``, the worst checked call;
- ``policy_gap`` (reactive): the largest gap of the raw action, its
  log-probability or the value from the reference's on the program's own
  features and noise, over the reference's largest magnitude of each.
"""

from __future__ import annotations

import torch

import stats
import tracing

TOLERANCE = 1e-4


def _off(prog: torch.Tensor, ref: torch.Tensor, dims) -> torch.Tensor:
    """Per env, whether ``prog`` departs from ``ref`` anywhere along
    ``dims`` (NaN departs)."""
    prog, ref = prog.to(torch.float32), ref.to(torch.float32)
    ok = (prog - ref).abs() <= TOLERANCE * (1.0 + ref.abs())
    return ~ok.all(dim=dims)


def start(ref, cfg: dict, initial) -> int:
    state, info = initial
    return int(ref.start_invalid(cfg, state, info['reset_stalled']))


def _diverged(prog: dict, refd: dict) -> torch.Tensor:
    bad = _off(prog['planes'], refd['planes'], 0)
    for k in ('reward', 'terminated', 'truncated'):
        bad |= (prog[k].to(torch.float32) != refd[k].to(torch.float32)).any(0)
    for k in ('obs', 'final'):
        if k in prog:
            bad |= _off(prog[k], refd[k], (0, 1))
    return bad


def _reference_call(ref, cfg: dict, mix: dict, cap: dict, dtype) -> dict:
    planes_in = ref.state_planes(cap['state_in'])
    k = mix.get('steps_per_launch', 1)
    planes, rew, term, trunc, blocks = ref.rollout(cfg, planes_in, cap['actions'], cap['seed'], k, dtype,
                                                   features_out='eps' in cap)
    out = {'planes': planes, 'reward': rew, 'terminated': term, 'truncated': trunc}
    if blocks is not None:
        feat0 = ref.features(*planes_in[0:4], planes_in[8], planes_in[9], planes_in[16], planes_in[17])
        out['obs'] = torch.cat([feat0[None], blocks[:-1, 0]])  # [T, 12, B]
        out['final'] = blocks[:, 1]
    return out


def _program(ref, cap: dict) -> dict:
    out = {'planes': ref.state_planes(cap['state_out'])}
    for k in ('reward', 'terminated', 'truncated', 'obs', 'final'):
        if k in cap:
            out[k] = cap[k]
    return out


def _policy_gap(cap: dict, mix: dict, lower: bool) -> float:
    """The program's (or with ``lower`` the control's) policy outputs of
    every step against the reference's, on the program's features."""
    from reference import policy

    hidden = mix['policy_hidden']
    w = policy.unpack(cap['weights'], mix['obs_dim'], hidden, mix['action_dim'])
    gaps, scale = [0.0] * 3, [0.0] * 3
    for t in range(cap['eps'].shape[0]):
        x = cap['obs'][t]
        want = policy.sample(w, x, cap['eps'][t], len(hidden))
        got = policy.sample(w, x, cap['eps'][t], len(hidden), lower=True) if lower else (
            cap['raw'][t], cap['logp'][t], cap['value'][t])
        for j, (p, r) in enumerate(zip(got, want)):
            gaps[j] = max(gaps[j], float((p.to(torch.float32) - r).abs().max()))
            scale[j] = max(scale[j], float(r.abs().max()))
    return max(g / max(s, 1e-30) for g, s in zip(gaps, scale))


def numbers(ref, cfg: dict, mix: dict, captures: dict, start_invalid: int, lower: bool = False) -> dict:
    """The compared numbers over the checked calls.  ``lower``: the control,
    the reference in the precision below the configuration's put in the
    program's place (bfloat16 for the env's float32; TF32 products for the
    policy's float32 with TF32 off, which a reactive cell compares alone)."""
    reactive = mix['kind'] == 'reactive'
    out = {'start_invalid': start_invalid}
    if not (lower and reactive):
        out['env_diverged'] = 0.0
    if reactive:
        out['policy_gap'] = 0.0
    for cap in captures.values():
        with torch.no_grad():
            if reactive:
                out['policy_gap'] = max(out['policy_gap'], _policy_gap(cap, mix, lower))
            if 'env_diverged' in out:
                refd = _reference_call(ref, cfg, mix, cap, torch.float32)
                got = _reference_call(ref, cfg, mix, cap, torch.bfloat16) if lower else _program(ref, cap)
                share = float(_diverged(got, refd).to(torch.float32).mean())
                out['env_diverged'] = max(out['env_diverged'], share)
    return out


def breakdown(parsed: dict, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time in the traced window, by
    name, and the idle time in it by the host span open at each gap."""
    by_op: dict = {}
    for s, e, name, _, _ in parsed['device']:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s)
    holes = stats.gaps([(s, e) for s, e, *_ in parsed['device']], lo, hi)
    names = tracing.innermost_at(parsed['spans'], [(s + e) / 2 for s, e in holes])
    by_span: dict = {}
    for (s, e), n in zip(holes, names):
        by_span[n or 'none'] = by_span.get(n or 'none', 0.0) + (e - s)
    return {'device_ops': sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
            'idle_gaps': sorted(([k, v] for k, v in by_span.items()), key=lambda kv: -kv[1])[:top]}
