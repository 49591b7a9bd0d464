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
leave-one-out path's in-place-AF semantics.  Individuals are processed in
blocks sized so the ``[block, K, M]`` float32 temporaries stay within
:data:`BLOCK_ELEMENTS`.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 elements per temporary of the [individuals, K, M] per-site pass:
# 2**28 is 1 GiB, a few of which coexist -- well inside an 80 GB card.
BLOCK_ELEMENTS = 1 << 28


def site_loglik(g0, g1, a):
    """log( g0*(1-a)^2 + g1*2a(1-a) + (1-g0-g1)*a^2 ), broadcasting."""
    oma = 1.0 - a
    like = g0 * oma * oma + g1 * 2.0 * a * oma + (1.0 - g0 - g1) * a * a
    return torch.log(like)


def _selected_site_ll(g0, g1, af_bank_t, col_idx, site_weight):
    """Yield ``(rows, ll [b, K, M] float32)`` per individual block: the
    weighted per-site log-likelihoods of the selected AF rows."""
    m, n = g0.shape
    k = col_idx.shape[1]
    b = max(1, BLOCK_ELEMENTS // max(k * m, 1))
    idx = col_idx.long()
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        a = af_bank_t[idx[lo:hi]]  # [b, K, M]
        ll = site_loglik(g0[:, lo:hi].t()[:, None, :],
                         g1[:, lo:hi].t()[:, None, :], a)
        yield slice(lo, hi), ll * site_weight


def _selected_sums(g0, g1, af_bank_t, col_idx, site_weight, dtype):
    n, k = col_idx.shape
    out = torch.empty((n, k), dtype=dtype, device=g0.device)
    for rows, ll in _selected_site_ll(g0, g1, af_bank_t, col_idx,
                                      site_weight):
        out[rows] = torch.sum(ll, dim=2, dtype=dtype)
    return out


def assign_loglik_selected(g0, g1, af_bank_t, col_idx, site_weight):
    """``[N, K]`` float32 bank-selected log-likelihoods, float32 sums.

    Args:
      g0, g1: float32 ``[M, N]``.
      af_bank_t: float32 ``[C, M]`` bank of AF rows, site-minor.
      col_idx: integer ``[N, K]`` -- bank row used for pair (i, k).
      site_weight: float32 ``[M]``.
    """
    return _selected_sums(g0, g1, af_bank_t, col_idx, site_weight,
                          torch.float32)


def assign_loglik_selected_f64(g0, g1, af_bank_t, col_idx,
                               site_weight) -> np.ndarray:
    """``[N, K]`` bank-selected log-likelihoods with float64 site sums
    (the LOO path's sum, reference glassy.py:101).  Returns np.float64."""
    return _selected_sums(g0, g1, af_bank_t, col_idx, site_weight,
                          torch.float64).cpu().numpy()


def _selected_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                             num_partitions: int, dtype):
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
    return out


def assign_loglik_selected_partitioned(g0, g1, af_bank_t, col_idx,
                                       site_weight, num_partitions: int):
    """Partitioned form of :func:`assign_loglik_selected`, float32 sums.
    Returns ``(ll [N, K], parts [N, P, K])`` as float32 tensors."""
    parts = _selected_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                                     num_partitions, torch.float32)
    return parts.sum(dim=2), parts.permute(0, 2, 1).contiguous()


def assign_loglik_selected_partitioned_f64(g0, g1, af_bank_t, col_idx,
                                           site_weight, num_partitions: int):
    """``(ll [N, K], parts [N, P, K])`` with float64 site sums, as NumPy
    float64 arrays; ``ll`` is the sum of the partition sums."""
    parts = _selected_partition_sums(g0, g1, af_bank_t, col_idx, site_weight,
                                     num_partitions, torch.float64)
    parts = parts.cpu().numpy()
    return parts.sum(axis=2), np.transpose(parts, (0, 2, 1))
