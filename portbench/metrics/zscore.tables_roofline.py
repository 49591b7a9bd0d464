"""The combo-table kernels' share of their roofline: the bound of the
tables' needed work (``zroofline.tables``: each GL pair and read-count pair
read once, one kept-site flag written) over the summed device time of the
two ``ztables_*`` kernels in the traced window.  A port without them
reads nothing."""

KERNEL = "ztables_"


def read(run):
    if run.trace is None or "ztables" not in run.work:
        return None
    seconds = run.trace.seconds("kernel", KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.work["ztables"].bound_s() / seconds
