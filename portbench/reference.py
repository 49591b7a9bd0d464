"""Plain PyTorch reference of the analyses the benchmark times.

It follows WGSassign's own semantics (mgdesaix/WGSassign: the MAF EM of
emMAF.py, the assignment and leave-one-out likelihoods of glassy.py), as
the repository's NumPy oracle documents them:

- EM: start at 0.25; per site ``w = (p1 + 2 p2) / (2 (p0 + p1 + p2))``,
  ``f' = mean over members of w``, clipped one ulp-scale inside (0, 1)
  (``EM_EPS``); a problem stops after the first update whose RMSE over the
  real sites is below ``tol`` (its iteration count is that update's
  number), or after ``max_iter``; float32 arithmetic, float64 RMSE sums;
- reference AF: that EM for every population over its members, clamped to
  ``[1/(2(n+1)), 1 - 1/(2(n+1))]``;
- leave-one-out: individual i's own population re-estimated without i,
  clamped with ``n - 1`` members, written into the AF matrix in place
  before i's likelihoods are taken, so a foreign column j holds the
  leave-one-out AF of the last member of j at or before i
  (``loo_bank_rows``);
- likelihood: float32 per-site ``log(g0 (1-a)^2 + g1 2a(1-a) + g2 a^2)``,
  summed over sites in float64.

Everything runs on the device of its inputs, blocked so the temporaries
stay within ``BLOCK_ELEMENTS``.  ``em_round`` and ``ll_round`` round the
EM weights before the member sums, and the likelihood's operands, to a
lower precision: the controls (``round_tf32``, ``round_bf16``).

This module imports neither JAX, nor the JAX package, nor the port.
"""

from __future__ import annotations

import numpy as np
import torch

EM_EPS = 1e-7
BLOCK_ELEMENTS = 1 << 27
_F32 = torch.float32
_F64 = torch.float64


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest (ties to even) at TF32's 10 mantissa bits,
    as TF32 tensor cores round their float32 operands."""
    i = x.contiguous().view(torch.int32)
    i = i + (0x0FFF + ((i >> 13) & 1))
    return (i & -0x2000).view(_F32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back."""
    return x.to(torch.bfloat16).to(_F32)


def em_weight_x2(g0, g1, f):
    """Twice the EM weight, ``(p1 + 2 p2) / (p0 + p1 + p2)``, broadcasting
    ``g0``/``g1`` against ``f`` (the factor 1/2 is exact and is applied
    after the member sum)."""
    omf = 1.0 - f
    p0 = g0 * (omf * omf)
    p1 = g1 * (2.0 * f * omf)
    p2 = (1.0 - g0 - g1) * (f * f)
    num = p1 + 2.0 * p2
    den = p0.add_(p1).add_(p2)
    return num.div_(den)


def site_loglik(g0, g1, a):
    """float32 per-site log-likelihood (glassy.py), broadcasting."""
    oma = 1.0 - a
    like = g0 * oma * oma + g1 * (2.0 * oma * a) + (1.0 - g0 - g1) * a * a
    return torch.log(like)


def _freeze(active, iters, rmse, tol, it):
    crossed = active & (rmse < tol)
    iters[crossed] = it + 1
    active &= ~crossed


def reference_af(g0, g1, pop_index, n_pops, max_iter, tol, em_round=None):
    """The all-population EM on ``[M, N]`` GL planes.

    Returns ``(af [M, K] float32 clamped, on the device; iters [K])``."""
    m, n = g0.shape
    dev = g0.device
    pop_index = np.asarray(pop_index)
    members = [torch.from_numpy(np.flatnonzero(pop_index == k)).to(dev)
               for k in range(n_pops)]
    sizes = np.array([len(x) for x in members], np.float64)
    cols = torch.from_numpy(pop_index.astype(np.int64)).to(dev)
    f = torch.full((m, n_pops), 0.25, dtype=_F32, device=dev)
    active = np.ones(n_pops, bool)
    iters = np.full(n_pops, max_iter, np.int64)
    rows = max(1, BLOCK_ELEMENTS // max(n, 1))
    for it in range(max_iter):
        if not active.any():
            break
        act = torch.from_numpy(active).to(dev)
        f_new = torch.empty_like(f)
        sq = torch.zeros(n_pops, dtype=_F64, device=dev)
        for lo in range(0, m, rows):
            hi = min(lo + rows, m)
            fb = f[lo:hi]
            w2 = em_weight_x2(g0[lo:hi], g1[lo:hi], fb.index_select(1, cols))
            if em_round is not None:
                w2 = em_round(w2)
            upd = torch.stack([w2.index_select(1, idx).sum(dim=1)
                               for idx in members], dim=1)
            upd = (upd * 0.5 / torch.from_numpy(sizes).to(dev, _F32))
            upd = torch.where(act, upd.clamp(EM_EPS, 1.0 - EM_EPS), fb)
            d = (upd - fb).to(_F64)
            sq += (d * d).sum(dim=0)
            f_new[lo:hi] = upd
        f = f_new
        _freeze(active, iters, np.sqrt(sq.cpu().numpy() / m), tol, it)
    lo_clamp = torch.from_numpy(1.0 / (2.0 * (sizes + 1.0))).to(dev, _F32)
    af = torch.minimum(torch.maximum(f, lo_clamp), 1.0 - lo_clamp)
    return af, iters


def loo_em(g0p, g1p, max_iter, tol, em_round=None):
    """The n leave-one-out EMs of one population, on its ``[n, M]`` member
    panels (rows in ascending individual order); problem j leaves member j
    out.  Returns ``(f [n, M] float32 unclamped, iters [n])``."""
    n, m = g0p.shape
    dev = g0p.device
    f = torch.full((n, m), 0.25, dtype=_F32, device=dev)
    active = np.ones(n, bool)
    iters = np.full(n, max_iter, np.int64)
    step = max(1, BLOCK_ELEMENTS // (n * n))
    for it in range(max_iter):
        if not active.any():
            break
        act = torch.from_numpy(active).to(dev)[:, None]
        f_new = torch.empty_like(f)
        sq = torch.zeros(n, dtype=_F64, device=dev)
        for lo in range(0, m, step):
            hi = min(lo + step, m)
            fb = f[:, lo:hi]
            # [member i, problem j, site]
            w2 = em_weight_x2(g0p[:, None, lo:hi], g1p[:, None, lo:hi],
                              fb[None, :, :])
            w2.diagonal(0, 0, 1).zero_()
            if em_round is not None:
                w2 = em_round(w2)
            upd = w2.sum(dim=0) * 0.5 / (n - 1.0)
            upd = torch.where(act, upd.clamp(EM_EPS, 1.0 - EM_EPS), fb)
            d = (upd - fb).to(_F64)
            sq += (d * d).sum(dim=1)
            f_new[:, lo:hi] = upd
        f = f_new
        _freeze(active, iters, np.sqrt(sq.cpu().numpy() / m), tol, it)
    return f, iters


def loo_bank_rows(pop_index, pop: int) -> np.ndarray:
    """``[N]``: the row of column ``pop``'s bank that individual i's
    likelihood reads, walking the individuals in order as the reference's
    in-place AF write does: the position among ``pop``'s members of the
    last member at or before i, or ``n_pop`` (the full-data AF row) where
    none comes before."""
    pop_index = np.asarray(pop_index)
    n_pop = int((pop_index == pop).sum())
    rows = np.empty(len(pop_index), np.int64)
    last, seen = n_pop, 0
    for i, p in enumerate(pop_index):
        if p == pop:
            last = seen
            seen += 1
        rows[i] = last
    return rows


def banked_loglik(g0, g1, bank, rows, ll_round=None):
    """``[N]`` float64: individual i's log-likelihood against AF row
    ``bank[rows[i]]`` (``bank`` ``[R, M]``), summed over sites."""
    m, n = g0.shape
    dev = g0.device
    sel = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
    out = torch.zeros(n, dtype=_F64, device=dev)
    step = max(1, BLOCK_ELEMENTS // max(n, 1))
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        a = bank[:, lo:hi].index_select(0, sel).t()
        x0, x1 = g0[lo:hi], g1[lo:hi]
        if ll_round is not None:
            x0, x1, a = ll_round(x0), ll_round(x1), ll_round(a)
        out += site_loglik(x0, x1, a).sum(dim=0, dtype=_F64)
    return out


def assignment_loglik(g0, g1, af, ll_round=None):
    """``[N, K]`` float64 assignment log-likelihoods of ``[M, N]`` GL
    planes against an ``[M, K]`` AF panel (on the device)."""
    k = af.shape[1]
    bank = af.t().contiguous()
    n = g0.shape[1]
    return torch.stack([banked_loglik(g0, g1, bank, np.full(n, j), ll_round)
                        for j in range(k)], dim=1)
