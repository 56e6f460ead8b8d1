"""The readings each cell's limits are set from: the program's compared
numbers on sound runs, and its control's, over many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--calls 2]

For each seed: the cell's env and traffic at the cell's size, set up as a
run sets them up, ``--calls`` collection calls from the initial state,
then the compared numbers of the program (``check.numbers``) and of the
control: the reference computed one precision below the configuration's
and put in the program's place (bfloat16 for the env's float32; TF32
products for the reactive policy's float32 with TF32 off).  Prints one JSON
line a seed, then the largest program reading and the smallest control
reading of each number.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [p for p in (str(HERE), str(HERE.parent)) if p not in sys.path]

import torch  # noqa: E402

import check  # noqa: E402
import harness  # noqa: E402
import manifest  # noqa: E402
import tracing  # noqa: E402


def readings(name: str, seeds: list, device: str = 'cuda', calls: int = 2, overrides: dict | None = None,
             root: Path = manifest.ROOT, log=None) -> list:
    bench = manifest.load(root)
    spec = manifest.cell(bench, name, root)
    mix, cfg = dict(spec['mix'], **(overrides or {})), spec['config']
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = importlib.import_module(f'reference.{cfg["family"]}')
    kind = importlib.import_module(f'traffic.{mix["kind"]}')
    out = []
    for seed in seeds:
        driver = kind.Driver(cfg, mix, dev, harness.seeds(seed), tracing.Spans())
        driver.setup()
        start = check.start(ref, cfg, driver.initial)
        captures = {}
        for i in range(calls):
            inputs = driver.draw(i)
            state_in = driver.state
            res = driver.call(i, inputs)
            driver.readback(res)
            captures[i] = driver.capture(i, state_in, inputs, res)
        driver.release()
        row = {'seed': seed, 'program': check.numbers(ref, cfg, mix, captures, start),
               'control': check.numbers(ref, cfg, mix, captures, start, lower=True)}
        out.append(row)
        if log:
            log(json.dumps(row))
    return out


def summary(rows: list) -> dict:
    keys = rows[0]['program'].keys()
    return {k: {'program_max': max(r['program'][k] for r in rows),
                'control_min': min((r['control'][k] for r in rows if k in r['control']), default=None)}
            for k in keys}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True, help='comma-separated')
    ap.add_argument('--calls', type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('the control runs on the card', file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(',')], calls=args.calls, log=print)
    print(json.dumps({'workload': args.workload, 'summary': summary(rows), 'card': harness.card_line()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
