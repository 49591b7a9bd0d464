"""The work the reference z-scores need, for the rooflines of the z-score
cell (``roofline.py`` counts the same way: each input byte read once and
each output byte written once per analysis, 15 float32 operations per EM
weight times each problem's convergence iteration).

- ``zloo_em``: a population's leave-one-out EMs on each problem's kept
  sites alone, the EM the reference runs.  The port's ``zloo_chunk`` runs
  them over the whole site axis with the kept sites only in the RMSE, so
  the unkept sites' updates count as waste, as replays do.
- ``tables``: the two passes behind the combo tables (``csrc/ztables.cu``)
  need one read of each individual's GL pair and read-count pair and one
  written kept-site flag a site; no float32 arithmetic worth counting.
"""

from __future__ import annotations

from portbench.roofline import F32, OPS_PER_WEIGHT, Work


def zloo_em(m: int, n_pop: int, kept, iters) -> Work:
    """The leave-one-out EMs of ``len(kept)`` problems of one population of
    ``n_pop`` members over ``[n_pop, m]`` member panels: problem j needs
    ``iters[j]`` updates of ``n_pop - 1`` member weights at each of its
    ``kept[j]`` sites.  Bytes: the two member panels and each problem's
    kept-site weights in, its AF row out."""
    weights = (n_pop - 1) * sum(int(s) * int(t) for s, t in zip(kept, iters))
    return Work(OPS_PER_WEIGHT * weights,
                F32 * (2 * n_pop + 2 * len(kept)) * m)


def tables(m: int, n: int, ad_bytes: int) -> Work:
    """The combo tables of ``n`` individuals over ``m`` sites: GL pairs
    (float32) and read-count pairs (``ad_bytes`` each) read once, one
    kept-site byte written."""
    return Work(0.0, m * n * (2 * F32 + 2 * ad_bytes + 1))
