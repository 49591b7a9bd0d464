"""``--profile DIR``: a ``torch.profiler`` trace of the run, with the
port's own spans and counters in it.

Counterpart of ``wgsassign_tpu/obs/profiling.py::maybe_profile``, which
wraps the run in ``jax.profiler.trace``.  Records host-side torch ops, plus
CUDA kernels and copies when the runtime's device is a GPU, and writes one
Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``, readable by Perfetto,
``chrome://tracing`` and TensorBoard's profiler plugin) into ``DIR``.  :class:`RunTimer` is the per-phase wall clock behind the run
summary, as in the JAX package.

:func:`span` and :func:`count` record only while a ``torch.profiler`` is
recording (``--profile``, or a benchmark's traced window).  A span is a
``record_function`` range, so it lands in the same trace as the kernels
and copies, on the same clock, and spans nest by containment.  It also
adds its host seconds, and the seconds the current CUDA stream took from
its entry to its exit (two timing events, no synchronize), to
:func:`span_totals`.  Names are ``wgsa.<layer>.<what>``.  With no profiler
recording, a span is one shared null context and a count does nothing: no
``record_function``, no allocation, no synchronize, and the computed
values are the same either way.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

# ~0.1 us a call: whether a torch.profiler records on this process
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts: defaultdict = defaultdict(int)
# span name -> [(host seconds, start event, end event)], events None off CUDA
_spans: defaultdict = defaultdict(list)


def _stream_event():
    """A timing event recorded on the current CUDA stream, or None where
    the process has not started CUDA."""
    if not torch.cuda.is_initialized():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Recorded:
    """A span while a profiler records: a ``record_function`` range, timed
    on the host clock and on the current CUDA stream."""

    __slots__ = ("name", "_range", "_t0", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._start = _stream_event()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self._t0
        _spans[self.name].append((host_s, self._start, _stream_event()))
        return self._range.__exit__(*exc)


def span(name: str):
    """A context manager: ``record_function(name)``, timed, while a
    profiler records, else a shared no-op."""
    if _recording():
        return _Recorded(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _recording():
        _counts[name] += int(n)


def counters() -> dict:
    """A copy of the counters, summed over every recorded window of the
    process."""
    return dict(_counts)


def span_totals() -> dict:
    """Per span name, summed over every recorded window of the process:
    ``calls``, ``host_s`` (host seconds from entry to exit) and
    ``device_s`` (seconds of the current CUDA stream from entry to exit:
    the work launched there inside the span, and any wait for the host
    within it; None off CUDA).  Waits for the spans' last events."""
    totals = {}
    for name, rows in _spans.items():
        device_s = None
        for _, start, end in rows:
            if start is not None and end is not None:
                end.synchronize()
                device_s = (device_s or 0.0) + 1e-3 * start.elapsed_time(end)
        totals[name] = {"calls": len(rows),
                        "host_s": sum(r[0] for r in rows),
                        "device_s": device_s}
    return totals


class RunTimer:
    """Accumulating phase timer; prints a run summary.  ``results`` holds
    what the CLI's sections computed (``reference_af``, ``loo``,
    ``reference_z``, ``assignment_z``: their result objects; ``mesh``: the
    ranks, backend and device), for a caller that drives ``main`` from
    Python and wants more than the output files hold.  Each phase is also
    the span ``wgsa.cli.<name>``."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.results = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("wgsa.cli." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self, counts=None):
        """Print the timing summary, then ``counts`` (a dict from
        :func:`counters`) when it holds any."""
        if not self.totals:
            return
        print("\n-- timing summary --")
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<14s} {total:8.3f}s  ({self.counts[name]}x)")
        if counts:
            print("-- counters --")
            for name, n in sorted(counts.items()):
                print(f"  {name:<26s} {n}")


@contextlib.contextmanager
def maybe_profile(trace_dir, device):
    """Wrap a block in ``torch.profiler.profile`` when a directory is
    given; ``device`` (a ``torch.device``) decides whether CUDA activity is
    recorded.  Yields a dict that, once the block ends, holds what
    :func:`count` added during it (nothing without a directory)."""
    counts = {}
    if not trace_dir:
        yield counts
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = counters()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield counts
    counts.update((k, v - before.get(k, 0)) for k, v in counters().items()
                  if v != before.get(k, 0))
    print(f"Wrote profiler trace to {trace_dir}")
