"""``em_chunk``'s share of its roofline: the bound of the reference-AF
EM's needed work (``roofline.reference_af_em``) over the summed device
time of the ``em_chunk`` kernel in the traced window."""

KERNEL = "em_chunk_kernel"


def read(run):
    if run.trace is None or "em_chunk" not in run.work:
        return None
    seconds = run.trace.seconds("kernel", KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * run.work["em_chunk"].bound_s() / seconds
