"""Share of the ``loo_chunk`` problem-iterations launched in the traced
window that the results needed: the port's ``loo_chunk.useful_iters``
over ``loo_chunk.launched_iters`` (``obs/profiling.py::counters``, which
count only while a profiler records, so only in the window).  The rest is
chunks replayed to stop a problem at its own convergence iteration."""


def read(run):
    if run.trace is None:
        return None
    try:
        from wgsassign_tpu_torch.obs.profiling import counters
    except ImportError:  # a port without counters
        return None
    counts = counters()
    launched = counts.get("loo_chunk.launched_iters", 0)
    if launched <= 0:
        return None
    return 100.0 * counts.get("loo_chunk.useful_iters", 0) / launched
