"""Host seconds per analysis in the port's ``wgsa.zscore.em`` spans:
each AF group's member gathers, chunked leave-one-out EMs
(``zloo_chunk``) and kept-AF gather.  Each span ends in a fetch or a
synchronise, so its host seconds include its device work.  The port times
its spans only while a profiler records, so only in the traced window
(``spantrace.port_span_seconds``)."""

from portbench.spantrace import port_span_seconds


def read(run):
    if run.trace is None or not run.analyses:
        return None
    seconds = port_span_seconds("wgsa.zscore.em", "host_s")
    return None if not seconds else seconds / run.analyses
