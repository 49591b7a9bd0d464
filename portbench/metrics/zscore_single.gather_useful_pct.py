"""Share of the gathered member-panel slots in the traced window that hold
a real member at a kept site: the port's ``zscore.gather_useful`` over
``zscore.gather_launched`` (``obs/profiling.py::counters``, counted only
while a profiler records).  The rest is padding: each AF group's panels
are ``[B, p_pad, s_pad]``, ``p_pad`` the largest population less one and
``s_pad`` a power of two at least the largest kept count.  A port without
the counters reads nothing."""


def read(run):
    if run.trace is None:
        return None
    try:
        from wgsassign_tpu_torch.obs.profiling import counters
    except ImportError:  # a port without counters
        return None
    counts = counters()
    launched = counts.get("zscore.gather_launched", 0)
    if launched <= 0:
        return None
    return 100.0 * counts.get("zscore.gather_useful", 0) / launched
