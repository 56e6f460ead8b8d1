"""The SASS of the split kernels, instructions per control cycle, on the card's machine.

Builds (or loads) the kernel library of the tree Python imports the package
from, disassembles it with ``cuobjdump -sass`` and prints one JSON line:

- per kernel, the instructions per control cycle of the consumer's loop (the
  loop that pops one cycle's values from the ring), the producer's loop (a
  cycle's normal pairs drawn, no physics) and the thread-per-env loop
  (pushing's B, C, C-feat and D by the floor friction's marker; planning's
  E, F and G, full layout, by Box-Muller's);
- the instruction mix of the consumer loops of B (circle and box): counts by
  opcode, the special-function (``MUFU``) and slow-path (``CALL``) ones
  among them;
- ``ptxas -v``'s registers and spills of kernels B and E.

With ``--kernel-h`` it prints instead the loops of kernel H's many-mover
variant (``planning_multi_many_kernel``, circle and box) with their
registers and spills: every loop (a backward branch and its target) in
address order, its static instruction count, how deep it nests, and the
opcodes that tell the walks apart (``DADD``: a pair's summed float64 sizes,
``MUFU.RSQ``: a square root, ``VOTE``: a warp vote, ``LDS``: shared loads;
``STL``/``LDL``: spills),
so the instructions a pair of the cycles' and of the candidate sets' walks
take can be read off.

The loop helpers are ``chip_smoke.py``'s (``--smoke``, by default the one
at the root of the checkout), so two trees can be read by one rule: run
this file by its path with each tree on ``PYTHONPATH`` and the same
``--smoke`` (a file run by its path finds the package only on
``PYTHONPATH``)::

    for t in build/parent .; do
        PYTHONPATH=$t python gymnasium_planar_robotics_tpu_torch/tools/sass_report.py --smoke chip_smoke.py
    done
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
from pathlib import Path

#: label -> (kernel instantiation, values a cycle pops, normal pairs a cycle draws, family)
KERNELS = {
    'B': ('pushing_cycles_kernelILb0ELb0ELb0E', 4, 2, 'pushing'),
    'B_box': ('pushing_cycles_kernelILb0ELb1ELb0E', 8, 4, 'pushing'),
    'C': ('pushing_autoreset_kernelILb0ELb0ELb0ELb0E', 4, 2, 'pushing'),
    'C_feat': ('pushing_autoreset_kernelILb0ELb0ELb0ELb1E', 4, 2, 'pushing'),
    'D': ('pushing_rollout_kernelILb0ELb0ELb0E', 4, 2, 'pushing'),
    'C_box': ('pushing_autoreset_kernelILb0ELb1ELb0ELb0E', 8, 4, 'pushing'),
    'C_feat_box': ('pushing_autoreset_kernelILb0ELb1ELb0ELb1E', 8, 4, 'pushing'),
    'D_box': ('pushing_rollout_kernelILb0ELb1ELb0E', 8, 4, 'pushing'),
    'E': ('planning_cycles_kernelILb0ELb1ELb0E', 4, 2, 'planning'),
    'E_box': ('planning_cycles_kernelILb1ELb1ELb0E', 8, 4, 'planning'),
    'F': ('planning_autoreset_kernelILb0ELb1ELb0E', 4, 2, 'planning'),
    'F_box': ('planning_autoreset_kernelILb1ELb1ELb0E', 8, 4, 'planning'),
    'G': ('planning_rollout_kernelILb0ELb1ELb0E', 4, 2, 'planning'),
    'G_box': ('planning_rollout_kernelILb1ELb1ELb0E', 8, 4, 'planning'),
}


def load_smoke(path: Path):
    spec = importlib.util.spec_from_file_location('chip_smoke_helpers', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def counts(cs, lib: str, kernel: str, q: int, pairs: int, family: str) -> dict:
    """Instructions a control cycle of the consumer's, the producer's and the
    thread-per-env loop of ``kernel`` (pushing: one instantiation holds both
    block shapes; planning: ``ELb1E`` with the producer, ``ELb0E`` without,
    a tree without that template parameter reports the one it has)."""
    def per_cycle(res):
        return res.get('instructions_per_cycle', res.get('error'))

    def no_physics(loop):
        return not any(cs.friction_marker(o, a) for o, a in loop)

    if family == 'pushing':
        return {'consumer': per_cycle(cs.sass_cycle_counts(lib, kernel, where=cs.pops(q))),
                'producer': per_cycle(cs.sass_cycle_counts(lib, kernel, cs.box_muller_marker, pairs, where=no_physics)),
                'thread_per_env': per_cycle(cs.sass_cycle_counts(lib, kernel, where=cs.pops(0)))}
    split = any(kernel + 'Lb1E' in ln for ln in cs.sass_text(lib).splitlines() if 'Function : ' in ln)
    if not split:
        return {'thread_per_env': per_cycle(cs.sass_cycle_counts(lib, kernel, cs.box_muller_marker, pairs))}
    return {'consumer': per_cycle(cs.sass_cycle_counts(lib, kernel + 'Lb1E', cs.shared_load_marker, q,
                                                       where=cs.pops(q))),
            'producer': per_cycle(cs.sass_cycle_counts(lib, kernel + 'Lb1E', cs.box_muller_marker, pairs)),
            'thread_per_env': per_cycle(cs.sass_cycle_counts(lib, kernel + 'Lb0E', cs.box_muller_marker, pairs))}


def consumer_mix(cs, lib: str, kernel: str, q: int) -> dict:
    """Opcode counts of the consumer's cycle loop of a pushing kernel."""
    loops = [loop for loop in cs.sass_loops(lib, kernel)
             if cs.pops(q)(loop) and any(cs.friction_marker(o, a) for o, a in loop)]
    if not loops:
        return {'error': f'no consumer loop in {kernel}'}
    ops = collections.Counter(o for o, _ in min(loops, key=len))
    return {'instructions': sum(ops.values()), 'mufu': {o: n for o, n in ops.items() if o.startswith('MUFU')},
            'call': sum(n for o, n in ops.items() if o.startswith('CALL')),
            'reconvergence': sum(n for o, n in ops.items() if o.startswith('BSSY')), 'top': ops.most_common(12)}


def loop_table(cs, lib: str, kernel: str) -> list:
    """Every loop of ``kernel`` (a substring of its mangled name) in address
    order: [first, last] address, instructions, nesting depth and marker
    opcode counts."""
    body, inside = [], False
    for ln in cs.sass_text(lib).splitlines():
        if 'Function : ' in ln:
            inside = kernel in ln
            continue
        m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);', ln)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    spans = []
    for addr, op, args in body:
        t = re.match(r'\s*(0x[0-9a-f]+|\d+)', args) if op.startswith('BRA') else None
        if t and int(t.group(1), 0) < addr:
            spans.append((int(t.group(1), 0), addr))
    out = []
    for lo, hi in sorted(set(spans)):
        ops = [o for a, o, _ in body if lo <= a <= hi]
        out.append({'span': [hex(lo), hex(hi)], 'instructions': len(ops),
                    'depth': sum(a <= lo and hi <= b and (a, b) != (lo, hi) for a, b in set(spans)),
                    **{k: sum(o.startswith(p) for o in ops) for k, p in (
                        ('DADD', 'DADD'), ('MUFU_RSQ', 'MUFU.RSQ'), ('VOTE', 'VOTE'), ('LDS', 'LDS'), ('STS', 'STS'),
                        ('FMUL', 'FMUL'), ('BRA', 'BRA'), ('STL', 'STL'), ('LDL', 'LDL'))}})
    return out


def ptxas_lines(build) -> dict:
    """``ptxas -v``'s registers and spills of each kernel in the build log."""
    regs, cur = {}, None
    for ln in build.build_info.get('log', '').splitlines():
        if 'Function properties for' in ln:
            cur = ln.split('Function properties for')[1].strip()
        elif cur and 'spill stores' in ln:
            regs[cur] = ln.strip()
        elif cur and 'Used' in ln and 'registers' in ln:
            regs[cur] = ln.split('Used')[1].split(',')[0].strip() + '; ' + regs.get(cur, '')
            cur = None
    return regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--smoke', default=str(Path(__file__).resolve().parents[2] / 'chip_smoke.py'),
                    help="the chip_smoke.py whose loop helpers to use")
    ap.add_argument('--kernel-h', action='store_true', help="the loops of kernel H's many-mover variant instead")
    args = ap.parse_args()
    cs = load_smoke(Path(args.smoke))
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import build

    build.lib()
    lib = build.build_info['path']
    if args.kernel_h:
        print(json.dumps({'lib': lib, 'loops': {shape: loop_table(cs, lib, f'planning_multi_many_kernelILb{box}E')
                                                for shape, box in (('circle', 0), ('box', 1))},
                          'ptxas': {k: v for k, v in ptxas_lines(build).items() if 'many' in k}}))
        return 0
    out = {'lib': lib, 'per_cycle': {name: counts(cs, lib, *spec) for name, spec in KERNELS.items()},
           'consumer_mix': {name: consumer_mix(cs, lib, KERNELS[name][0], KERNELS[name][1]) for name in ('B', 'B_box')}}
    out['ptxas'] = {k: v for k, v in ptxas_lines(build).items() if 'cycles_kernel' in k}
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
