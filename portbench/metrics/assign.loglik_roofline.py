"""The likelihood pass's share of its roofline: the bound of its needed
work (``roofline.loglik``: the GL planes, the AF panel and the site weight
read once) over the summed device time of every kernel of the window
(copies and memsets excluded: the analysis launches nothing else)."""


def read(run):
    if run.trace is None or "loglik" not in run.work:
        return None
    seconds = run.trace.seconds("kernel")
    if seconds <= 0:
        return None
    return 100.0 * run.work["loglik"].bound_s() / seconds
