"""Run some phases of ``chip_smoke.py`` alone: every other phase but
``card_build`` records ``{}`` (later code reads ``.get`` of each) and runs
nothing.  From the root of a checkout, on the card::

    python -m gymnasium_planar_robotics_tpu_torch.tools.smoke_phases sharded_main_path sharded_ppo

Its exit code is the script's; a phase run this way is the same code as in
the whole run, without the earlier phases' warm state.
"""

from __future__ import annotations

import sys
from pathlib import Path

_OLD = """    def phase(name):
        def wrap(fn):
            t0 = time.perf_counter()"""
_NEW = """    def phase(name):
        def wrap(fn):
            if name not in KEEP:
                report['phases'][name] = {}
                return {}
            t0 = time.perf_counter()"""


def main(argv=None) -> int:
    names = set(sys.argv[1:] if argv is None else argv) | {'card_build'}
    path = Path('chip_smoke.py').resolve()
    src = path.read_text()
    if _OLD not in src:
        raise SystemExit('chip_smoke.py has no phase decorator of the expected form')
    scope = {'__name__': 'chip_smoke_phases', '__file__': str(path), 'KEEP': names}
    exec(compile(src.replace(_OLD, _NEW), str(path), 'exec'), scope)
    return scope['main']()


if __name__ == '__main__':
    sys.exit(main())
