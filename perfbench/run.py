"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each compared
number beside its limit, also printed as the last lines of standard
error).  A record of what the line leaves out goes to
``perfbench_runs/<cell>-<seed>-t<trace>.json``.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the benchmark's own modules, then the program at the checkout's root
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main())
