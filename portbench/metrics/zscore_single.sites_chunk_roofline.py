"""``sites_chunk``'s share of its roofline: the bound of the single-read
z-score EMs' needed work (``zroofline.zloo_em``: each problem's kept sites
x the population's other members x 15 operations x its convergence
iteration, keyed ``sites_chunk`` by the entry) over the summed device time
of the ``sites_chunk`` kernel in the traced window.  Replayed chunks and
the panels' padded members and slots are waste, not work."""

KERNEL = "sites_chunk_kernel"


def read(run):
    if run.trace is None or "sites_chunk" not in run.work:
        return None
    seconds = run.trace.seconds("kernel", KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.work["sites_chunk"].bound_s() / seconds
