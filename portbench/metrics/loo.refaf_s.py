"""Seconds per analysis in ``estimate_reference_af`` (host clock, a span
around the call that ends in a device synchronise)."""


def read(run):
    spans = run.spans.get("refaf")
    return sum(spans) / len(spans) if spans else None
