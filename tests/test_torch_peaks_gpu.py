"""Kernel I (the roofline's peak probes) against its plain PyTorch version,
on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without one;
the module imports no JAX:

    python -m pytest --noconftest -o addopts='' -m gpu tests/test_torch_peaks_gpu.py -q

Tolerances: fma exact against ``fma_once_plain`` (the chain rounded once a
step, as ``fmaf`` rounds), which sees a dropped multiply: at K = 64 the
multiplier moves the result by about 4e-6 relative, near the 1e-5 that the
JAX package's rounding (``fma_plain``: the product, then the sum) would
need; transc atol 1e-6 (the CUDA math library's ``logf`` and ``cosf`` are
within 2 ulps of the plain version's; the chain contracts toward its fixed
point, so a difference does not grow with K).
"""

import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build, peaks

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('transc', [False, True], ids=['fma', 'transc'])
def test_probe_matches_plain_and_counts_its_launch(cuda, transc):
    n = peaks.probe_length(cuda, transc)
    x = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda) * 0.98 + 0.01
    k = 16 if transc else 64
    name = 'peak_transc' if transc else 'peak_fma'
    before = kernels.LAUNCHES[name]
    got = peaks.peak(x, k, transc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    plain = peaks.transc_plain if transc else peaks.fma_once_plain
    tol = dict(rtol=0, atol=1e-6) if transc else dict(rtol=0, atol=0)
    ref = plain(x, k)
    assert kernels.LAUNCHES[name] == before + 1  # the plain version launches nothing
    torch.testing.assert_close(got, ref, **tol)
    # K = 0 returns the input, a ragged tail of threads is masked
    torch.testing.assert_close(peaks.peak(x, 0, transc), x, rtol=0, atol=0)
    short = x[: peaks.chains(transc) * 1000].contiguous()  # 1000 threads: the last block's tail is idle
    torch.testing.assert_close(peaks.peak(short, k, transc), plain(short, k), **tol)


def test_probe_rejects_what_it_cannot_take_and_raises_on_a_refused_launch(cuda, monkeypatch):
    c = peaks.chains(False)
    with pytest.raises(ValueError, match='multiple'):
        peaks.peak(torch.zeros(c * 10 + 1, device=cuda), 4)
    with pytest.raises(TypeError, match='float32'):
        peaks.peak(torch.zeros(c * 10, device=cuda, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match='contiguous|shape'):
        peaks.peak(torch.zeros((c * 10, 2), device=cuda)[:, 0], 4)
    lib = build.lib()
    before = kernels.LAUNCHES['peak_fma']
    monkeypatch.setattr(lib, 'gprt_peak', lambda *args: 9)  # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match='cudaError 9'):
        peaks.peak(torch.zeros(c * 10, device=cuda), 4)
    assert kernels.LAUNCHES['peak_fma'] == before
