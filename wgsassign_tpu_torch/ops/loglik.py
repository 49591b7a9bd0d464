"""Assignment log-likelihoods (counterpart of ``ops/loglik.py``).

Per (site, individual, population) the assignment likelihood under HWE is

    P(D_si | pop k) = g0 (1-a)^2 + g1 2a(1-a) + g2 a^2,   a = af[s, k]

and the log-likelihood sums the float32 per-site logs over sites.  The sum
is taken in float64 on the device, as the reference's ``np.sum(...,
dtype=float)`` does; the JAX package's f32 block partials and host combine
existed only because the TPU has no float64.  The ``*_f64`` functions are
that form; the plain ones sum in float32 (``--f32_sums``).

"Selected" forms give each (individual, population) pair its own AF row of
a site-minor bank ``af_bank_t [C, M]`` through ``col_idx [N, K]`` -- the
leave-one-out path's in-place-AF semantics.  The unselected forms
(``--get_pop_like``) are the selected ones over the bank ``af.T`` with
``col_idx[i, k] = k``.  Individuals are processed in blocks sized so the
``[block, K, M]`` float32 temporaries stay within :data:`BLOCK_ELEMENTS`:
the JAX op fuses the ``[M, N, K]`` product into the site reduction, a
plain torch broadcast would materialise it (3.6 GB at 1M x 180 x 5).

With several ranks each rank sums its window of the site axis and ``reduce``
(``Runtime.all_reduce_sum``) adds the ranks' ``[N, K]`` or ``[N, K, P]``
sums, in the dtype of the sum: float64, or float32 under ``--f32_sums``.
Partition p holds the sites with ``s % P == p``; every rank's window starts
at a multiple of P, so a site's partition does not depend on the number of
ranks.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 elements per temporary of the [individuals, K, M] per-site pass:
# 2**28 is 1 GiB, a few of which coexist -- well inside an 80 GB card.
BLOCK_ELEMENTS = 1 << 28


def site_like(g0, g1, a):
    """g0*(1-a)^2 + g1*2a(1-a) + (1-g0-g1)*a^2, broadcasting."""
    oma = 1.0 - a
    return g0 * oma * oma + g1 * 2.0 * a * oma + (1.0 - g0 - g1) * a * a


def site_loglik(g0, g1, a):
    """log( g0*(1-a)^2 + g1*2a(1-a) + (1-g0-g1)*a^2 ), broadcasting."""
    return torch.log(site_like(g0, g1, a))


def _selected_site_like(g0, g1, af_bank_t, col_idx):
    """Yield ``(rows, like [b, K, M] float32)`` per individual block: the
    per-site likelihoods of the selected AF rows."""
    m, n = g0.shape
    k = col_idx.shape[1]
    b = max(1, BLOCK_ELEMENTS // max(k * m, 1))
    idx = col_idx.long()
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        a = af_bank_t[idx[lo:hi]]  # [b, K, M]
        yield slice(lo, hi), site_like(g0[:, lo:hi].t()[:, None, :],
                                       g1[:, lo:hi].t()[:, None, :], a)


def _selected_site_ll(g0, g1, af_bank_t, col_idx, site_weight):
    """Yield ``(rows, ll [b, K, M] float32)`` per individual block: the
    weighted per-site log-likelihoods of the selected AF rows."""
    for rows, like in _selected_site_like(g0, g1, af_bank_t, col_idx):
        yield rows, torch.log(like) * site_weight


def _selected_sums(g0, g1, af_bank_t, col_idx, site_weight, dtype,
                   reduce=None):
    n, k = col_idx.shape
    out = torch.empty((n, k), dtype=dtype, device=g0.device)
    for rows, ll in _selected_site_ll(g0, g1, af_bank_t, col_idx,
                                      site_weight):
        out[rows] = torch.sum(ll, dim=2, dtype=dtype)
    return out if reduce is None else reduce(out)


def assign_loglik_selected(g0, g1, af_bank_t, col_idx, site_weight,
                           reduce=None):
    """``[N, K]`` float32 bank-selected log-likelihoods, float32 sums.

    Args:
      g0, g1: float32 ``[M, N]``.
      af_bank_t: float32 ``[C, M]`` bank of AF rows, site-minor.
      col_idx: integer ``[N, K]`` -- bank row used for pair (i, k).
      site_weight: float32 ``[M]``.
    """
    return _selected_sums(g0, g1, af_bank_t, col_idx, site_weight,
                          torch.float32, reduce)


def assign_loglik_selected_f64(g0, g1, af_bank_t, col_idx,
                               site_weight, reduce=None) -> np.ndarray:
    """``[N, K]`` bank-selected log-likelihoods with float64 site sums
    (the LOO path's sum, reference glassy.py:101).  Returns np.float64."""
    return _selected_sums(g0, g1, af_bank_t, col_idx, site_weight,
                          torch.float64, reduce).cpu().numpy()


def _selected_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                             num_partitions: int, dtype, reduce=None):
    """``[N, K, P]`` partition sums; partition p holds the sites with
    ``s % P == p`` of the (padded) site axis."""
    m = g0.shape[0]
    n, k = col_idx.shape
    p = num_partitions
    if m % p != 0:
        raise ValueError(
            f"site axis ({m}) must be padded to a multiple of "
            f"num_partitions ({p})")
    out = torch.empty((n, k, p), dtype=dtype, device=g0.device)
    for rows, ll in _selected_site_ll(g0, g1, af_bank_t, col_idx,
                                      site_weight):
        out[rows] = torch.sum(ll.reshape(ll.shape[0], k, m // p, p), dim=2,
                              dtype=dtype)
    return out if reduce is None else reduce(out)


def assign_loglik_selected_partitioned(g0, g1, af_bank_t, col_idx,
                                       site_weight, num_partitions: int,
                                       reduce=None):
    """Partitioned form of :func:`assign_loglik_selected`, float32 sums.
    Returns ``(ll [N, K], parts [N, P, K])`` as float32 tensors."""
    parts = _selected_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                                     num_partitions, torch.float32, reduce)
    return parts.sum(dim=2), parts.permute(0, 2, 1).contiguous()


def assign_loglik_selected_partitioned_f64(g0, g1, af_bank_t, col_idx,
                                           site_weight, num_partitions: int,
                                           reduce=None):
    """``(ll [N, K], parts [N, P, K])`` with float64 site sums, as NumPy
    float64 arrays; ``ll`` is the sum of the partition sums."""
    parts = _selected_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                                     num_partitions, torch.float64, reduce)
    parts = parts.cpu().numpy()
    return parts.sum(axis=2), np.transpose(parts, (0, 2, 1))


# --- unselected forms: every individual against the same [M, K] panel ----

def _identity_columns(n: int, af) -> tuple:
    """``(bank [K, M], col_idx [N, K])`` that make the selected forms
    evaluate every individual against every column of ``af [M, K]``."""
    k = af.shape[1]
    col_idx = torch.arange(k, device=af.device).expand(n, k)
    return af.t().contiguous(), col_idx


def assign_loglik(g0, g1, af, site_weight, reduce=None):
    """Full ``[N, K]`` assignment log-likelihood matrix, float32 sums.

    Args:
      g0, g1: float32 ``[M, N]``.
      af: float32 ``[M, K]`` population allele frequencies.
      site_weight: float32 ``[M]`` (0 for padded sites).

    Returns: float32 ``[N, K]`` tensor.
    """
    bank, col_idx = _identity_columns(g0.shape[1], af)
    return assign_loglik_selected(g0, g1, bank, col_idx, site_weight, reduce)


def assign_loglik_f64(g0, g1, af, site_weight, reduce=None) -> np.ndarray:
    """``[N, K]`` assignment log-likelihoods with float64 site sums
    (reference glassy.py:38).  Returns np.float64."""
    bank, col_idx = _identity_columns(g0.shape[1], af)
    return assign_loglik_selected_f64(g0, g1, bank, col_idx, site_weight,
                                      reduce)


def assign_loglik_partitioned(g0, g1, af, site_weight, num_partitions: int,
                              reduce=None):
    """Per-partition float32 sums ``[P, N, K]``: partition p holds the sites
    with ``s % P == p``.  The (padded) site count must be a multiple of P."""
    bank, col_idx = _identity_columns(g0.shape[1], af)
    parts = _selected_partition_sums(g0, g1, bank, col_idx, site_weight,
                                     num_partitions, torch.float32, reduce)
    return parts.permute(2, 0, 1)


def assign_loglik_partitioned_f64(g0, g1, af, site_weight,
                                  num_partitions: int,
                                  reduce=None) -> np.ndarray:
    """Partitioned sums ``[P, N, K]`` with float64 site sums, as NumPy."""
    bank, col_idx = _identity_columns(g0.shape[1], af)
    parts = _selected_partition_sums(g0, g1, bank, col_idx, site_weight,
                                     num_partitions, torch.float64, reduce)
    return np.transpose(parts.cpu().numpy(), (2, 0, 1))


def check_loglik_inputs(g0, g1, af, site_weight, reduce=None) -> None:
    """Sanitizer for the reachable ``log(0)``: malformed GL triples
    (negative GLs, or g0+g1 > 1 making g2 negative) drive the per-site
    likelihood to zero or below, which the likelihood passes would fold
    into silent ``-inf``/NaN sums.  Run under ``--debug_checks`` before the
    assignment and LOO likelihood passes.  Counts the (site, individual,
    population) cells of ``af [M, K]`` with ``like <= 0`` or NaN on
    weighted sites, blocked over individuals like the passes, and raises
    ``ValueError`` with the count."""
    bank, col_idx = _identity_columns(g0.shape[1], af)
    weighted = site_weight > 0.0
    bad = 0
    for _, like in _selected_site_like(g0, g1, bank, col_idx):
        bad += int((((like <= 0.0) | torch.isnan(like)) & weighted).sum())
    if reduce is not None:  # every rank raises, or none
        bad = int(reduce(torch.tensor(bad, device=g0.device)))
    if bad:
        raise ValueError(
            f"non-positive assignment likelihood at {bad} (site, individual, "
            "population) cells -- malformed GL triples (negative GLs or "
            "g0+g1 > 1)?"
        )
