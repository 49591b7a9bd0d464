"""The card's peaks and the work each analysis needs, for rooflines.

A kernel's bound is the larger of its operations over the float32 peak and
its bytes over the memory bandwidth.  The work counted is what the inputs
need, whatever implements it: each input byte read once and each output
byte written once per call, and 15 float32 operations per EM weight
(``g2 = 1 - g0 - g1`` and the accumulate included, the divide counted as
one) times the iterations each EM problem needs (its convergence
iteration).  A chunk replayed to stop a problem at its own iteration is
therefore waste, not work.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_WEIGHT = 15
# per (site, individual, population) term of the likelihood pass: 1 - a,
# the three products and two sums of the likelihood, g2, the log, the
# site weight and the accumulate
OPS_PER_LOGLIK_TERM = 15
F32 = 4


@dataclass
class Work:
    ops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.nbytes + other.nbytes)

    def scaled(self, times: float) -> "Work":
        return Work(self.ops * times, self.nbytes * times)

    def bound_s(self) -> float:
        """The least time the card could take for this work."""
        return max(self.ops / PEAK_F32_OPS, self.nbytes / PEAK_BYTES)


def reference_af_em(m: int, pop_sizes, iters) -> Work:
    """The all-population EM (``em_chunk``): ``[M, N]`` GL planes in,
    ``[K, M]`` AF out; population k needs ``iters[k]`` updates of its
    ``pop_sizes[k]`` member weights a site."""
    weights = m * sum(int(n) * int(t) for n, t in zip(pop_sizes, iters))
    n, k = sum(int(x) for x in pop_sizes), len(pop_sizes)
    return Work(OPS_PER_WEIGHT * weights, F32 * (2 * m * n + k * m))


def loo_em(m: int, n_pop: int, iters) -> Work:
    """One population's leave-one-out EMs (``loo_chunk``): ``[n, M]``
    member panels in, ``[n, M]`` AF out; problem j needs ``iters[j]``
    updates of ``n - 1`` member weights a site."""
    weights = m * (n_pop - 1) * sum(int(t) for t in iters)
    return Work(OPS_PER_WEIGHT * weights, F32 * 3 * n_pop * m)


def loglik(m: int, n: int, k: int, af_rows: int) -> Work:
    """A likelihood pass of ``n`` individuals against ``k`` AF columns each,
    taken from ``af_rows`` rows of ``m`` sites: the GL planes, the AF rows
    and the site weight read once, ``[n, k]`` float64 sums written."""
    return Work(OPS_PER_LOGLIK_TERM * m * n * k,
                F32 * (2 * m * n + af_rows * m + m) + 8 * n * k)
