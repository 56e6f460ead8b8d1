"""The control at a size a test run holds, on the CPU: the reference one
precision below the configuration's, put in the program's place, fails
the cell's limits, while the program's own readings pass them.  On the
card (``gpu``), the same at the cells' own sizes on three seeds."""

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import control  # noqa: E402
import manifest  # noqa: E402

CELLS = [w['name'] for w in manifest.load()['workloads']]


def limits(cell):
    return json.loads((HERE / 'workloads' / f'{cell}.json').read_text())['limits']


def _fails(numbers, lim):
    return any(not v <= lim[k] for k, v in numbers.items())


@pytest.mark.parametrize('cell', CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    torch.set_num_threads(2)
    rows = control.readings(cell, [5, 6, 7], 'cpu', calls=1, overrides={'envs': 64, 'steps_per_call': 16})
    lim = limits(cell)
    for row in rows:
        assert not _fails(row['program'], lim), row
        assert _fails(row['control'], lim), row


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rows = control.readings(cell, [101, 102, 103], 'cuda')
    lim = limits(cell)
    for row in rows:
        assert not _fails(row['program'], lim), row
        assert _fails(row['control'], lim), row
