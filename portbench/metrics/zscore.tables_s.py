"""Host seconds per analysis in the port's ``wgsa.zscore.tables`` spans:
the combo tables of ``build_tables``: both passes over the cohort,
the ``[B, W * W]`` table ops and each block's one fetch.  Each span
ends in a fetch or a synchronise, so its host seconds include its device
work.  The port times its spans only while a profiler records, so only in
the traced window (``spantrace.port_span_seconds``)."""

from portbench.spantrace import port_span_seconds


def read(run):
    if run.trace is None or not run.analyses:
        return None
    seconds = port_span_seconds("wgsa.zscore.tables", "host_s")
    return None if not seconds else seconds / run.analyses
