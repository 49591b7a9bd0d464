"""Share of the z-sum slots launched in the traced window that hold a kept
site: the port's ``zscore.kept_slots`` over ``zscore.launched_slots``
(``obs/profiling.py::counters``, counted only while a profiler records).
The rest is padding: each block runs every individual over ``s_pad``
slots, a power of two at least the largest kept-site count."""


def read(run):
    if run.trace is None:
        return None
    try:
        from wgsassign_tpu_torch.obs.profiling import counters
    except ImportError:  # a port without counters
        return None
    counts = counters()
    launched = counts.get("zscore.launched_slots", 0)
    if launched <= 0:
        return None
    return 100.0 * counts.get("zscore.kept_slots", 0) / launched
