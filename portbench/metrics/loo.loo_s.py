"""Seconds per analysis in ``leave_one_out`` (host clock, a span around
the call that ends in a device synchronise)."""


def read(run):
    spans = run.spans.get("loo")
    return sum(spans) / len(spans) if spans else None
