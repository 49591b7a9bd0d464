"""``--profile DIR``: a ``torch.profiler`` trace of the run.

Counterpart of ``wgsassign_tpu/obs/profiling.py::maybe_profile``, which
wraps the run in ``jax.profiler.trace``.  Records host-side torch ops, plus
CUDA kernels and copies when the runtime's device is a GPU, and writes one
Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``, readable by Perfetto,
``chrome://tracing`` and TensorBoard's profiler plugin) into ``DIR``.  :class:`RunTimer` is the per-phase wall clock behind the run
summary, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class RunTimer:
    """Accumulating phase timer; prints a run summary.  ``results`` holds
    what the CLI's sections computed (``reference_af``, ``loo``,
    ``reference_z``, ``assignment_z``: their result objects; ``mesh``: the
    ranks, backend and device), for a caller that drives ``main`` from
    Python and wants more than the output files hold."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.results = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self):
        if not self.totals:
            return
        print("\n-- timing summary --")
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<14s} {total:8.3f}s  ({self.counts[name]}x)")


@contextlib.contextmanager
def maybe_profile(trace_dir, device):
    """Wrap a block in ``torch.profiler.profile`` when a directory is
    given; ``device`` (a ``torch.device``) decides whether CUDA activity is
    recorded."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
    print(f"Wrote profiler trace to {trace_dir}")
