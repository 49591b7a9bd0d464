"""Device seconds per analysis in the port's ``wgsa.zscore.gather`` spans:
the gathered EM's ``[B, P, S]`` member panels of each AF group (two
advanced-index gathers from the ``[M, N]`` GL planes), timed by the port
on the CUDA stream from each span's entry to its exit, in the traced
window only (``spantrace.port_span_seconds``).  A port without the span
reads nothing."""

from portbench.spantrace import port_span_seconds


def read(run):
    if run.trace is None or not run.analyses:
        return None
    seconds = port_span_seconds("wgsa.zscore.gather", "device_s")
    return None if not seconds else seconds / run.analyses
