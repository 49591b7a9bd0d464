"""Batched sums of the assignment z statistic on the device (counterpart of
``wgsassign_tpu/ops/zscore_ops.py::zscore_sums_batch_compact``).

Per kept site ``s`` of individual ``b`` with AF ``a`` and HWE genotype
prior ``P = [(1-a)^2, 2a(1-a), a^2]``:

  observed:   W_obs  = sum_s log(GL_s . P_s)
  expected:   W_mu_s = sum_{splits x of depth D_s} lg(s, x) * wt(s, x)
  variance:   V_s    = sum_x (W_mu_s - lg(s, x))^2 * wt(s, x)

with ``lg = log(meanGL[row] . P_s)`` and ``wt = readProb[row] . P_s`` for the
combo-table row ``rows_by_depth[b, D_s, x]`` of split ``(D_s - x, x)``.

The JAX package loops over (depth d, split x) with scalar table rows, which
suits the TPU's vector unit.  Here the loop runs over the split ``x`` only:
each site gathers its own depth's row for that split, and the term is added
where ``x <= D_s``.  A site's splits are still summed in ascending ``x``, so
the values match the JAX op to rounding, with C instead of ~C^2 / 2 passes.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch.ops import log


def zscore_sums_batch_compact(g0k, g1k, a, weight, site_depth,
                              rows_by_depth, like_tab, fact_tab,
                              sum_dtype=None):
    """Masked z sums for a block of B individuals.

    Args:
      g0k, g1k: float32 ``[B, S]`` kept-site GLs of each individual.
      a: float32 ``[B, S]`` AF at the kept sites.
      weight: float32 ``[B, S]``, 1.0 on real kept sites.
      site_depth: integer ``[B, S]`` total read depth per kept site.
      rows_by_depth: integer ``[B, C, C]`` combo row of split x at depth d.
      like_tab: float32 ``[B, R, 3]`` mean GL triple per combo.
      fact_tab: float32 ``[B, R, 3]`` read probability per combo.

      sum_dtype: dtype the per-site float32 terms are summed in; None is
        float32, as the JAX op sums them.  float64 is for checks that
        separate the rounding of these sums from other differences.

    Returns ``(w_obs, w_mu, w_var)``, three ``[B]`` tensors (float32, or
    ``sum_dtype``).
    """
    b, c, _ = rows_by_depth.shape
    p0 = (1.0 - a) * (1.0 - a)
    p1 = 2.0 * (1.0 - a) * a
    p2 = a * a
    w_obs_site = log(g0k * p0 + g1k * p1 + (1.0 - g0k - g1k) * p2)

    depth = site_depth.long()
    rbd = rows_by_depth.reshape(b, c * c).long()
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    terms = []
    w_mu_site = torch.zeros_like(a)
    for x in range(c):
        valid = depth >= x
        rows = torch.gather(rbd, 1, depth * c + x)  # [B, S]
        mg = [torch.gather(like_tab[:, :, k], 1, rows) for k in range(3)]
        rp = [torch.gather(fact_tab[:, :, k], 1, rows) for k in range(3)]
        lg = log(mg[0] * p0 + mg[1] * p1 + mg[2] * p2)
        wt = rp[0] * p0 + rp[1] * p1 + rp[2] * p2
        terms.append((valid, lg, wt))
        w_mu_site = w_mu_site + torch.where(valid, lg * wt, zero)
    w_var_site = torch.zeros_like(a)
    for valid, lg, wt in terms:
        dv = w_mu_site - lg
        w_var_site = w_var_site + torch.where(valid, dv * dv * wt, zero)

    return (torch.sum(w_obs_site * weight, dim=1, dtype=sum_dtype),
            torch.sum(w_mu_site * weight, dim=1, dtype=sum_dtype),
            torch.sum(w_var_site * weight, dim=1, dtype=sum_dtype))
