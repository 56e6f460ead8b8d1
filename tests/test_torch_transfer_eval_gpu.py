"""``tools/transfer_eval.py``'s reduced planning protocol on the card.

Every test needs a CUDA device (``gpu`` marker) and skips without one.  This
module imports no JAX (the card's machine has none):

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_transfer_eval_gpu.py -q -s

``train_planning`` for 120 iterations at 256 envs, then the in-engine eval
of 256 episodes (seed 100): the budget and the success floor of the JAX
package's ``tests/test_transfer.py::test_planning_policy_transfers_to_reference``
(its in-engine half).  The result is printed as one JSON line.
"""

import json
import statistics

import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning
from gymnasium_planar_robotics_tpu_torch.tools import transfer_eval

pytestmark = pytest.mark.gpu


def test_planning_reduced_protocol_learns():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    timings = {}
    policy, (config, params) = transfer_eval.train_planning(iters=120, batch=256, seed=0, log=None,
                                                            device='cuda', timings=timings)
    eng = transfer_eval.eval_in_engine(planning, config, params, policy, 256, seed=100)
    print(json.dumps({'engine': eng, 'iter_ms_median': statistics.median(timings['iter_ms'])}))
    assert eng['success'] > 0.5, f'training failed in-engine: {eng}'
