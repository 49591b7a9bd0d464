"""The whole analysis's share of the card's float32 peak: the operations
the z-score EMs need (``zroofline``; the combo tables count bytes only)
over the peak times the traced window (the work summed over its
analyses)."""

from portbench.roofline import PEAK_F32_OPS


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    ops = sum(w.ops for w in run.work.values())
    return 100.0 * ops / (PEAK_F32_OPS * run.trace.window_s)
