"""Port parity: kernel I's plain versions (the roofline's peak probes) and
the roofline's arithmetic.

``fma_kern`` and ``transc_kern`` are closures inside the JAX package's
``bench._microbench_peaks`` (``bench.py:523-540``) and cannot be called
alone, so their bodies are restated here in ``jax.numpy`` and run op by op
at small K (jitted, the fused ``log``/``cos`` read up to 2e-5 off the
op-by-op ones in some runs of this suite).  Tolerances: fma exact (both
round the product, then the sum, in f32; a tolerance would have to stay
below the multiplier's own effect, about K * 2^-24 relative, for the check
to see the multiply at all); transc atol 2e-7 (XLA's and PyTorch's CPU
``log`` and ``cos`` may differ by an ulp; the chain contracts toward its
fixed point, so a difference does not grow with K).
"""

import json
from fractions import Fraction

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import peaks
from gymnasium_planar_robotics_tpu_torch.utils import profiling, roofline


def jax_fma(x, k):
    acc = x
    for _ in range(k):
        acc = acc * 1.0000001 + x
    return acc


def jax_transc(x, k):
    acc = x
    for _ in range(k):
        u = acc * 0.49 + 0.5
        acc = jnp.cos(jnp.sqrt(-2.0 * jnp.log(u))) * 0.5 + 0.5
    return acc


@pytest.mark.parametrize('k', [1, 4, 64])
def test_plain_probes_match_the_jax_bodies(k):
    x = np.random.default_rng(k).uniform(0.0, 1.0, 4096).astype(np.float32)
    before = dict(kernels.LAUNCHES)
    got = peaks.peak(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_fma(jnp.asarray(x), k)))
    got = peaks.peak(torch.from_numpy(x), k, transc=True).numpy()
    want = np.asarray(jax_transc(jnp.asarray(x), k))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert ((got > 0) & (got < 1)).all()
    assert kernels.LAUNCHES == before  # the plain versions launch nothing


def test_fma_once_rounds_each_step_once():
    """``fma_once_plain``, which the card's ``fmaf`` chain is held to bit for
    bit: each step's float64 product and sum are exact (checked in exact
    rationals), so its one rounding to f32 is the fused multiply-add's.  At
    K = 64 it differs from the chain that drops the multiply, so an exact
    comparison sees a kernel that does."""
    k = 64
    x = np.random.default_rng(7).uniform(0.01, 0.99, 256).astype(np.float32)
    got = peaks.fma_once_plain(torch.from_numpy(x), k).numpy()
    scale = Fraction(float(np.float32(peaks.FMA_SCALE)))
    assert scale == 1 + Fraction(1, 2**23)
    for xi, gi in zip(x[:16], got[:16]):
        acc = xi
        for _ in range(k):
            exact = Fraction(float(acc)) * scale + Fraction(float(xi))
            assert Fraction(float(exact)) == exact  # float64 holds it exactly
            acc = np.float32(float(exact))
        assert acc == gi
    no_multiply = x.copy()
    for _ in range(k):
        no_multiply = no_multiply + x
    assert (no_multiply != got).mean() > 0.9


def test_peaks_are_a_measurement_of_the_card():
    with pytest.raises(ValueError, match='card'):
        roofline.microbench_peaks('cpu')
    with pytest.raises(ValueError, match='CUDA'):
        peaks.peak_cuda(torch.zeros(16), 2, False)


def test_rollout_costs_and_roofline_fractions():
    """The per env-step counts come from ``OPS`` (the CUDA sources): one
    pushing step is 40 cycles, the step's extra and 32 candidates; the
    fractions are rate * count / peak and the bound is the largest."""
    costs = roofline.rollout_costs()
    flops, transc, nbytes = costs['pushing rollout']
    ops = roofline.OPS
    assert flops == 40 * ops['pushing_cycle'][0] + ops['pushing_step_extra'][0] + 32 * ops['pushing_candidate'][0]
    assert transc == 40 * ops['pushing_cycle'][1] + ops['pushing_step_extra'][1] + 32 * ops['pushing_candidate'][1]
    assert nbytes == (19 + 32 * 5 + 19) * 4 / 32
    m4 = roofline.rollout_costs()['planning 4-mover rollout']
    assert m4[0] + m4[1] == roofline.ops_total(*roofline.multi_env_terms(4, 40, False, True, False))
    peaks_ = {'fma_tflops': 60.0, 'transc_gops': 1000.0, 'hbm_gbs': 3000.0}
    lines = []
    rows = roofline.roofline({'pushing rollout': 1e7, 'planning 4-mover rollout': 2e6}, peaks_, log=lines.append)
    r = rows[0]
    assert r['frac_f32'] == pytest.approx(1e7 * flops / 60e12) and r['frac_hbm'] == pytest.approx(1e7 * nbytes / 3e12)
    assert r['frac_transcendental'] == pytest.approx(1e7 * transc / 1e12) and r['bound'] == 'transcendental'
    assert r['speed_of_light_env_steps_per_s'] == pytest.approx(1e7 / r['frac_transcendental'])
    assert r['frac_f32_published'] == pytest.approx(1e7 * flops / 67e12)
    metrics = [json.loads(ln)['metric'] for ln in lines]
    assert metrics == ['roofline pushing rollout', 'roofline planning 4-mover rollout', 'roofline peaks']
    assert roofline.PUBLISHED_CLOCK == pytest.approx(1.98e9, rel=2e-3)


def test_profiling_trace_and_meter_on_the_cpu():
    with profiling.trace() as prof:
        torch.ones(8).add_(1.0)
    s = profiling.trace_summary(prof)
    assert s['device_kernels'] == 0 and s['launch_calls'] == 0 and s['device_ms'] == 0.0
