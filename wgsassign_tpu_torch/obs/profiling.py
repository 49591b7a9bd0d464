"""``--profile DIR``: a ``torch.profiler`` trace of the run.

Counterpart of ``wgsassign_tpu/obs/profiling.py::maybe_profile``, which
wraps the run in ``jax.profiler.trace``.  Records host-side torch ops, plus
CUDA kernels and copies when the runtime's device is a GPU, and writes one
Chrome trace (``<host>_<pid>.<ns>.pt.trace.json``, readable by Perfetto,
``chrome://tracing`` and TensorBoard's profiler plugin) into ``DIR``.  The
per-phase wall clock stays with ``wgsassign_tpu.obs.profiling.RunTimer``.
"""

from __future__ import annotations

import contextlib


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
