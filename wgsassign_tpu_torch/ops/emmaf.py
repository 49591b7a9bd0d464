"""Allele-frequency EM, plain PyTorch (counterpart of ``ops/emmaf.py``).

Model and convergence rule as in the JAX package: per site, the EM update
over individuals with genotype likelihoods ``(g0, g1, g2 = 1 - g0 - g1)`` is

    w_i = (p1 + 2 p2) / (2 (p0 + p1 + p2)),   f' = mean_i w_i

and a population stops when the RMSE over real sites of its update drops
below ``tol``; populations freeze independently, so each one's iteration
count matches an independent run.

These are the plain versions, iterating one update per loop step on the
host.  The main path runs the chunked EMs of :mod:`.fused_em` instead,
which take T iterations per kernel launch.
"""

from __future__ import annotations

import torch

_F32 = torch.float32

# The EM iterate lives in the open interval (0, 1): at f == 1.0 the weight
# denominator vanishes for members with g2 == 0 (0/0), and float32 rounding
# of the member mean can land exactly on 1.0.  Each update is clipped one
# ulp-scale inside the interval.
_EM_EPS = 1e-7


def em_weights(g0, g1, f):
    """Posterior expected minor-allele dosage / 2 per (site, individual);
    ``g0``/``g1`` and ``f`` broadcast against each other."""
    omf = 1.0 - f
    p0 = g0 * omf * omf
    p1 = g1 * 2.0 * f * omf
    p2 = (1.0 - g0 - g1) * f * f
    return (p1 + 2.0 * p2) / (2.0 * (p0 + p1 + p2))


def _masked_rmse(f_new, f_old, site_weight, m_real):
    """Per-column RMSE over real (unpadded) sites: sqrt(sum(w*d^2)/m)."""
    d = f_new - f_old
    sq = torch.sum(d * d * site_weight[:, None], dim=0)
    return torch.sqrt(sq / m_real)


def _iterate(update, f0, n_problems, diff_fn, max_iter, tol, device):
    """The shared while-loop of the plain EMs: problems freeze as they
    converge; returns ``(f, iters, converged)``."""
    tol = torch.tensor(tol, dtype=_F32, device=device)
    f = f0
    active = torch.ones(n_problems, dtype=torch.bool, device=device)
    iters = torch.full((n_problems,), max_iter, dtype=torch.int32,
                       device=device)
    it = 0
    while it < max_iter and bool(active.any()):
        f_new = update(f, active)
        diff = diff_fn(f_new, f)
        newly = active & (diff < tol)
        iters = torch.where(newly, torch.full_like(iters, it + 1), iters)
        active = active & (diff >= tol)
        f = f_new
        it += 1
    return f, iters, ~active


def em_maf_pops(g0, g1, membership, pop_index, site_weight, m_real,
                max_iter: int, tol):
    """All-K-population MAF EM.

    Args:
      g0, g1: float32 ``[M, N]`` (M may be padded).
      membership: float32 ``[N, K]`` one-hot population membership.
      pop_index: integer ``[N]`` population index per individual.
      site_weight: float32 ``[M]`` 1.0 on real sites, 0.0 on padding.
      m_real: number of real sites (RMSE denominator).

    Returns ``(f [M, K], iters [K] int32, converged [K] bool)``.

    The per-individual AF lookup is an exact gather, and the member sum is a
    float32 matrix product with TF32 off (``make_runtime`` sets it).
    """
    m = g0.shape[0]
    k = membership.shape[1]
    inv_counts = 1.0 / torch.sum(membership, dim=0)
    m_real = torch.tensor(m_real, dtype=_F32, device=g0.device)
    pop_index = pop_index.long()

    def update(f, active):
        w = em_weights(g0, g1, f[:, pop_index])
        f_upd = torch.clamp((w @ membership) * inv_counts,
                            _EM_EPS, 1.0 - _EM_EPS)
        return torch.where(active[None, :], f_upd, f)

    f0 = torch.full((m, k), 0.25, dtype=_F32, device=g0.device)
    return _iterate(
        update, f0, k,
        lambda fn, fo: _masked_rmse(fn, fo, site_weight, m_real),
        max_iter, tol, g0.device,
    )


def em_maf_loo_group(g0p, g1p, site_weight, m_real, max_iter: int, tol):
    """Batched leave-one-out MAF EM for one population.

    ``g0p``/``g1p`` are the members' GLs ``[n_p, M]`` (site-minor); row
    ``j`` of the result is the AF with member ``j`` left out.  The member
    sum loops over members, adding member ``i``'s weights under every
    problem's AF with problem ``i`` masked, so no ``[n_p, n_p, M]`` tensor
    is built.

    Returns ``(f [n_p, M], iters [n_p] int32, converged [n_p] bool)``.
    """
    npop, m = g0p.shape
    keep = 1.0 - torch.eye(npop, dtype=_F32, device=g0p.device)
    inv = 1.0 / (npop - 1.0)
    m_real = torch.tensor(m_real, dtype=_F32, device=g0p.device)

    def update(f, active):
        acc = torch.zeros_like(f)
        for i in range(npop):
            acc += em_weights(g0p[i], g1p[i], f) * keep[i][:, None]
        f_upd = torch.clamp(acc * inv, _EM_EPS, 1.0 - _EM_EPS)
        return torch.where(active[:, None], f_upd, f)

    def diff(fn, fo):
        d = fn - fo
        return torch.sqrt(torch.sum(d * d * site_weight[None, :], dim=1)
                          / m_real)

    f0 = torch.full((npop, m), 0.25, dtype=_F32, device=g0p.device)
    return _iterate(update, f0, npop, diff, max_iter, tol, g0p.device)


def clamp_af(f, n_pop):
    """Clamp allele frequencies to ``[1/(2(n+1)), 1 - 1/(2(n+1))]``;
    ``n_pop`` is a scalar or a per-column ``[K]`` vector of sample sizes."""
    n_pop = torch.as_tensor(n_pop, dtype=_F32, device=f.device)
    min_val = 1.0 / (2.0 * (n_pop + 1.0))
    return torch.clamp(f, min_val, 1.0 - min_val)
