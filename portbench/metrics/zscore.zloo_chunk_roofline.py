"""``zloo_chunk``'s share of its roofline: the bound of the z-score EMs'
needed work (``zroofline.zloo_em``: each problem's kept sites x the
population's other members x 15 operations x its convergence iteration)
over the summed device time of the ``zloo_chunk`` kernel in the traced
window."""

KERNEL = "zloo_chunk_kernel"


def read(run):
    if run.trace is None or "zloo_chunk" not in run.work:
        return None
    seconds = run.trace.seconds("kernel", KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.work["zloo_chunk"].bound_s() / seconds
