"""Host seconds per analysis in the port's ``wgsa.refaf.fetch`` span: the
clamped AF panel's device-to-host copy and the host transpose and cast
that build the ``[M, K]`` array in ``estimate_reference_af``.  The port
times its spans only while a profiler records, so only in the traced
window (``spantrace.port_span_seconds``)."""

from portbench.spantrace import port_span_seconds


def read(run):
    if run.trace is None or not run.analyses:
        return None
    seconds = port_span_seconds("wgsa.refaf.fetch", "host_s")
    return None if not seconds else seconds / run.analyses
