"""Profiling and tracing of the port.

Counterpart of ``gymnasium_planar_robotics_tpu/utils/profiling.py``:
``trace`` captures a ``torch.profiler`` trace of the enclosed block (host
and card), ``trace_summary`` reads its kernel launches and device time.

Spans and counters inside the program, off by default:

- ``span(name)``: a host span on ``time.perf_counter_ns``, recorded as
  ``(name, start_ns, end_ns, parent, call)`` (``parent``: the index in
  ``read_spans()`` of the enclosing span; ``call``: that of the enclosing
  ``gprt.rollout`` span, one collection call; None outside one).  Under an
  active ``torch.profiler`` it also opens ``record_function(name)``, so the
  span shows in the Chrome trace as a user annotation on the device
  records' clock.  A span never synchronises and never reads a device
  value.  The program's spans: ``gprt.rollout`` (every call of the fused
  and reactive rollouts), ``gprt.launch`` (``ops/kernels.dispatch``, entry
  to return, on either device) and ``gprt.policy`` (a reactive rollout's
  policy step and the clamp of its action).
- Counters: ``restarts`` (restarts run: an env-step whose restart tested
  a candidate), ``stalled`` (restarts that found no valid candidate) and
  ``trials`` (candidates tested; planning: candidate sets, start plus
  goal), exact int64 sums kept on the device of the batch.  The rollouts
  that launch kernel C, C-feat, F or H (or their plain versions) add the
  kernels' own ``stalled`` and ``trials`` rows once a call
  (``count_restarts``); the K-step kernels D and G write no such rows.

``enable`` switches them on and clears what was recorded, ``disable``
switches them off, ``read_spans`` and ``read_counters`` hand back what was
recorded.  Switched off, a span is one branch and a shared context that
does nothing, and the rollouts enqueue no counting operation: nothing is
allocated.
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path

import torch

#: the calls that launch a kernel: the CUDA runtime's (cuda*) and its low-level API's (cu*)
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel', 'cuLaunchKernelEx')
#: the program's span names
ROLLOUT, LAUNCH, POLICY = 'gprt.rollout', 'gprt.launch', 'gprt.policy'
COUNTERS = ('restarts', 'stalled', 'trials')
#: spans kept in memory between two ``enable`` calls; later ones are dropped (counted in ``Tracer.dropped``)
MAX_SPANS = 1 << 20


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


class Tracer:
    """The switches, the span buffer and the device counters."""

    def __init__(self):
        self.spans_on = False
        self.counters_on = False
        self.clear()

    def clear(self) -> None:
        self.records: list = []  # [name, start_ns, end_ns, parent, call]; end_ns None while open
        self.stack: list = []  # the open spans' indices (None: dropped)
        self.dropped = 0
        self.counts: dict = {}  # device -> int64 [restarts, stalled, trials]


TRACER = Tracer()


#: a switched-off span: one shared context that does nothing
OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ('name', 'index', 'annotation')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tr = TRACER
        parent = tr.stack[-1] if tr.stack else None
        index = len(tr.records)
        if index >= MAX_SPANS:
            index = None
            tr.dropped += 1
        else:
            call = index if self.name == ROLLOUT else (None if parent is None else tr.records[parent][4])
            tr.records.append([self.name, time.perf_counter_ns(), None, parent, call])
        tr.stack.append(index)
        self.index = index
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        tr = TRACER
        if self.index is not None:
            tr.records[self.index][2] = time.perf_counter_ns()
        tr.stack.pop()
        return False


def span(name: str):
    """Span ``name`` around the ``with`` block while spans are on; else the
    shared context ``OFF``."""
    return _Span(name) if TRACER.spans_on else OFF


def spanned(name: str):
    """Decorator: the function runs inside span ``name`` while spans are on,
    and is called straight after one branch while they are off."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not TRACER.spans_on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count_restarts(rows) -> None:
    """Add one rollout call's restart rows to the counters: ``rows``, each
    step's ``[stalled, trials]`` planes as the kernel wrote them (f32
    holding whole numbers), ``[T, 2, B]`` or a list of ``[2, B]`` on one
    device.  Enqueues a few reductions and an in-place add; reads nothing
    back."""
    r = rows if isinstance(rows, torch.Tensor) else torch.stack(rows)
    sums = torch.stack([(r[:, 1] > 0).sum(), (r[:, 0] > 0.5).sum(), r[:, 1].to(torch.int64).sum()])
    total = TRACER.counts.get(r.device)
    if total is None:
        TRACER.counts[r.device] = sums
    else:
        total.add_(sums)


def enable(spans: bool = True, counters: bool = True) -> None:
    """Switch spans and counters on or off, and clear what was recorded."""
    TRACER.clear()
    TRACER.spans_on, TRACER.counters_on = bool(spans), bool(counters)


def disable() -> None:
    """Switch spans and counters off; what was recorded stays readable."""
    TRACER.spans_on = TRACER.counters_on = False


def read_spans() -> list:
    """The spans since ``enable``: ``(name, start_ns, end_ns, parent,
    call)``, in the order they opened (``end_ns`` None while open)."""
    return [tuple(r) for r in TRACER.records]


def read_counters() -> dict:
    """The counters since ``enable``, summed over devices; the read is the
    one synchronise (once per device)."""
    total = [0] * len(COUNTERS)
    for sums in TRACER.counts.values():
        total = [a + b for a, b in zip(total, sums.tolist())]
    return dict(zip(COUNTERS, total))
