"""Profiling and throughput telemetry.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace of the enclosed block (host
and card), ``trace_summary`` reads its kernel launches and device time, and
``ThroughputMeter`` is a host-side steps-per-second meter.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

#: the calls that launch a kernel: the CUDA runtime's (cuda*) and its low-level API's (cu*)
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel', 'cuLaunchKernelEx')


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the enclosed block, host and (where there is
    one) card; yields the profiler.  With ``log_dir``, writes a Chrome trace
    ``trace.json`` there."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / 'trace.json'))


def trace_summary(prof) -> dict:
    """What a trace holds: ``launch_calls`` (the runtime's kernel launches,
    any library's), ``device_kernels`` (kernels the card ran) and their
    summed ``device_ms``."""
    launches, kernels, device_us = 0, 0, 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            device_us += evt.time_range.elapsed_us()
        elif evt.name in LAUNCH_CALLS:
            launches += 1
    return {'launch_calls': launches, 'device_kernels': kernels, 'device_ms': device_us / 1e3}


class ThroughputMeter:
    """Env-steps per second over a window, on the host's clock.  The caller
    synchronises with the card between ticks (``torch.cuda.synchronize()``),
    or the meter counts enqueued work as done."""

    def __init__(self):
        self._t0 = None
        self._steps = 0
        self.rate = 0.0

    def tick(self, env_steps: int) -> float:
        """Record ``env_steps`` completed steps; returns the running rate.
        The first call only arms the timer (returns 0.0)."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return 0.0
        self._steps += env_steps
        dt = now - self._t0
        if dt > 0:
            self.rate = self._steps / dt
        return self.rate

    def reset(self):
        """Clear the window; the next ``tick`` re-arms the timer."""
        self._t0 = None
        self._steps = 0
