"""``loo_chunk``'s share of its roofline: the bound of the leave-one-out
EMs' needed work (``roofline.loo_em``) over the summed device time of the
``loo_chunk`` kernel in the traced window."""

KERNEL = "loo_chunk_kernel"


def read(run):
    if run.trace is None or "loo_chunk" not in run.work:
        return None
    seconds = run.trace.seconds("kernel", KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.work["loo_chunk"].bound_s() / seconds
