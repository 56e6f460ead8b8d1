"""The counted work of one env step, taken from the plain reference's own
operations: what ``costs/<config>.json`` freezes for ``env_step_roofline``.

    python3 perfbench/opcount.py <config>

prints the counts of the configuration's file.  Each part of the step that
the reference's ``work(cfg)`` names is traced into a graph of tensor
operations (``make_fx``) and the operations that none of its outputs
needs are dropped (such as the normals of a draw the step only skips).
Then every operation whose result is floating point or boolean counts
once per element of its result, divided by the envs: an add, multiply,
compare, select, min, max, clamp bound, sign, abs or logic operation as
``f32``; a division, square root, log, exp, cos or sin as ``special``; a
reduction over ``n`` elements ``n - 1``.  Copies, views, gathers, index
and integer operations (the Philox stream) count nothing.  Any other
operation stops the count.

The parts: ``cycle`` is ``cycles_2`` less ``cycles_1`` (what ``cycles_1``
lacks of a cycle is the last latch update, which no output needs);
``step`` is one rollout step with its signals less ``num_cycles`` cycles
and the whole candidate search (``restart_<cand_k>``), so that
``num_cycles x cycle + step`` is the rollout step's count less its search;
``restart`` is ``restart_1``, the least a restart needs (its first
candidate or set); ``features`` is what handing on the feature blocks
adds to the step.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(HERE),) if p not in sys.path]

import torch  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

F32 = {'add', 'sub', 'rsub', 'mul', 'neg', 'abs', 'sign', 'maximum', 'minimum', 'where', 'gt', 'ge', 'lt', 'le',
       'eq', 'ne', 'bitwise_and', 'bitwise_or', 'bitwise_xor', 'bitwise_not', 'logical_and', 'logical_or',
       'logical_not', 'clamp_min', 'clamp_max'}
SPECIAL = {'div', 'reciprocal', 'sqrt', 'rsqrt', 'log', 'log1p', 'exp', 'cos', 'sin', 'tan', 'atan2', 'tanh', 'pow'}
REDUCE = {'any', 'all', 'sum', 'amax', 'amin'}
FREE = {'scalar_tensor', '_to_copy', 'unsqueeze', 'squeeze', 'expand', 'select', 'slice', 'view', 'reshape',
        '_unsafe_view', 'clone', 'stack', 'cat', 'full', 'full_like', 'zeros', 'zeros_like', 'ones_like',
        'empty_like', 'index', 'gather', 'triu_indices', 'argmax', 't', 'transpose', 'permute', 'lift_fresh_copy',
        'alias', 'detach', 'copy', 'split', 'unbind', 'new_zeros'}


def count(fn, inputs: tuple) -> dict:
    """``{'f32': n, 'special': n}`` a env of the operations ``fn(*inputs)``
    needs for its outputs (the last axis of each input is the envs)."""
    graph = make_fx(fn)(*inputs).graph
    graph.eliminate_dead_code()
    envs = inputs[0].shape[-1]
    out = {'f32': 0, 'special': 0}
    for node in graph.nodes:
        if node.op != 'call_function' or not hasattr(node.target, 'overloadpacket'):
            continue  # a placeholder, the output, or taking an item of a tuple
        name = node.target.overloadpacket.__name__
        val = node.meta['val']
        if not isinstance(val, torch.Tensor) or not (val.is_floating_point() or val.dtype == torch.bool):
            continue
        if name in F32:
            out['f32'] += val.numel()
        elif name == 'clamp':
            bounds = list(node.args[1:3]) + [node.kwargs.get(k) for k in ('min', 'max')]
            out['f32'] += val.numel() * sum(b is not None for b in bounds)
        elif name in SPECIAL:
            out['special'] += val.numel()
        elif name in REDUCE:
            out['f32'] += node.args[0].meta['val'].numel() - val.numel()
        elif name not in FREE:
            raise ValueError(f'opcount has no rule for {node.target}')
    for k, v in out.items():
        if v % envs:
            raise ValueError(f'{v} {k} operations do not divide among {envs} envs')
        out[k] = v // envs
    return out


def derive(cfg: dict) -> dict:
    """The counted work of one env step of the configuration ``cfg``."""
    ref = importlib.import_module(f'reference.{cfg["family"]}')
    parts = {name: count(*part) for name, part in ref.work(cfg).items()}
    n, k = cfg['env']['num_cycles'], cfg['cand_k']
    out = {'cycle': {}, 'step': {}, 'restart': parts['restart_1'], 'features': {}}
    for kind in ('f32', 'special'):
        cycle = parts['cycles_2'][kind] - parts['cycles_1'][kind]
        out['cycle'][kind] = cycle
        out['step'][kind] = parts['step'][kind] - n * cycle - parts[f'restart_{k}'][kind]
        out['features'][kind] = parts['step_features'][kind] - parts['step'][kind]
        if out['step'][kind] < 0:
            raise ValueError('the step needs less than its cycles and its restart')
    return out


def main(argv: list | None = None) -> int:
    import manifest

    name = (argv or sys.argv[1:])[0]
    conf = next(c for c in manifest.load()['configs'] if c['name'] == name)
    torch.manual_seed(0)
    print(json.dumps(derive(json.loads((manifest.ROOT / conf['file']).read_text()))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
