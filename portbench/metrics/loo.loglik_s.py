"""Device seconds per analysis in the port's ``wgsa.loglik.*`` spans: the
float64 selected likelihood pass of ``leave_one_out``, its result fetch
included, timed by the port on the CUDA stream from each span's entry to
its exit, in the traced window only (``spantrace.port_span_seconds``)."""

from portbench.spantrace import port_span_seconds


def read(run):
    if run.trace is None or not run.analyses:
        return None
    seconds = port_span_seconds("wgsa.loglik.", "device_s")
    return None if not seconds else seconds / run.analyses
