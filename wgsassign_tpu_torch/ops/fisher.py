"""Fisher-information / effective-sample-size ops (counterpart of
``wgsassign_tpu/ops/fisher.py``; reference fisher.py / fisher_cy.pyx).

Per (site, individual) with GLs ``(g0, g1, g2)`` and the individual's
population AF ``th``:

    u    = g0*(1-th)^2 + g1*2*th*(1-th) + g2*th^2         (site likelihood)
    n1   = 2*(g0 + g2 - 2*g1)                              (d2u/dth2)
    n2   = th*n1 + 2*(g1 - g0)                             (du/dth)
    term = -(n1/u - (n2/u)^2)    = -d^2/dth^2 log u        (observed info)

(fisher_cy.pyx:12-30).  Population info is the sum of ``term`` over members:
one float32 matmul against the one-hot membership matrix (full float32: the
runtime turns TF32 off).  Effective sample size
``ne = 0.5 * info * th * (1-th)`` (fisher_cy.pyx:32-39); the individual-level
ne is its mean over sites (fisher.py:58), summed here in float64.
"""

from __future__ import annotations

import torch


def _fisher_term(g0, g1, th):
    g2 = 1.0 - g0 - g1
    omt = 1.0 - th
    u = g0 * omt * omt + g1 * 2.0 * th * omt + g2 * th * th
    n1 = 2.0 * (g0 + g2 - 2.0 * g1)
    n2 = th * n1 + 2.0 * (g1 - g0)
    r = n2 / u
    return -(n1 / u - r * r)


def fisher_obs_pops(g0, g1, af, membership, pop_index, site_weight, m_real):
    """Population- and individual-level observed Fisher info and Ne.

    Args:
      g0, g1: float32 ``[M, N]``.
      af: float32 ``[M, K]`` clamped population AFs.
      membership: float32 ``[N, K]``; pop_index: integer ``[N]``.
      site_weight: float32 ``[M]``; m_real: real site count.

    Returns:
      ``(f_obs [M, K], ne_obs [M, K], ne_ind [N])`` tensors: rows beyond the
      real site count are junk (mask before use); ``ne_ind`` is the float64
      sum over weighted sites divided by ``m_real``.
    """
    th_ind = af.index_select(1, pop_index)  # [M, N], exact gather
    term = _fisher_term(g0, g1, th_ind)  # [M, N]
    f_obs = torch.matmul(term, membership)
    ne_obs = 0.5 * f_obs * af * (1.0 - af)
    ne_term = 0.5 * term * th_ind * (1.0 - th_ind)  # [M, N]
    ne_ind = torch.sum(ne_term * site_weight[:, None], dim=0,
                       dtype=torch.float64) / m_real
    return f_obs, ne_obs, ne_ind
