"""Plain PyTorch reference of WGSassign's z-scores for the CPU tests.

The semantics of ``portbench/zreference.py`` (WGSassign.py:346-384,
425-446, zscore.py, zscore_cy.pyx), written in the reference's own loop
form: one individual at a time, its leave-one-out EM gathered onto its
kept sites alone.  Per individual i:

- combos (Ar, Aa) of i's sites with their counts and float64 mean GL
  triples; the combo filter (total depth 1 under ``single_read``, else
  count above the threshold and total depth not 0; at least two), then
  only depths D with all D + 1 splits kept; the site filter (combo kept,
  GL at the mean's largest entry within 0.01 of the mean);
- AF: reference mode, the EM of i's population without i on i's kept
  sites (float32, start 0.25, stop at the first update whose RMSE over
  them is below ``tol``), clamped to ``[1/(2 n_p), 1 - 1/(2 n_p)]``;
  assignment mode, the AF panel's column of i's assigned population;
- z: per-site float32 terms, ``Aa = 0..D`` enumerated, float64 sums.

Raises :class:`Filtered` with the reference's message for the first
individual whose filters leave too little.  Imports neither JAX, the JAX
package nor the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EM_EPS = 1e-7
_F32, _F64 = torch.float32, torch.float64
MESSAGES = (
    "Not enough allele-count combinations were kept! Too stringent "
    "filtering?",
    "No complete depth classes survived filtering (no depth has all of "
    "its allele-count splits observed)",
    "No loci were kept! Too stringent filtering?",
)


class Filtered(ValueError):
    pass


def tables(gl_i, ad_i, n_threshold, single_read, e):
    """``(kept sites, {(Ar, Aa): (mean GL float32 [3], read probs float32
    [3])})`` of one individual: ``gl_i`` float32 ``[M, 2]``, ``ad_i``
    integer ``[M, 2]``."""
    g0 = torch.as_tensor(gl_i[:, 0])
    g1 = torch.as_tensor(gl_i[:, 1])
    g = torch.stack([g0, g1, (1.0 - g0) - g1], dim=1)
    pairs = [tuple(p) for p in np.asarray(ad_i, np.int64).tolist()]
    combos = sorted(set(pairs))
    row = {c: r for r, c in enumerate(combos)}
    inv = torch.tensor([row[p] for p in pairs])
    count = torch.bincount(inv, minlength=len(combos))
    mean = torch.zeros((len(combos), 3), dtype=_F64)
    mean.index_add_(0, inv, g.to(_F64))  # sites in order
    mean /= count[:, None].to(_F64)
    tot = np.asarray([a + b for a, b in combos])
    if single_read:
        keep = tot == 1
    else:
        keep = (count.numpy() > n_threshold) & (tot != 0)
    if keep.sum() < 2:
        raise Filtered(MESSAGES[0])
    for d in set(tot[keep].tolist()):
        if (keep & (tot == d)).sum() <= d:
            keep &= tot != d
    if keep.sum() == 0:
        raise Filtered(MESSAGES[1])
    top = mean.argmax(dim=1)[inv]
    close = (mean[inv].gather(1, top[:, None])
             - g.gather(1, top[:, None]).to(_F64)).abs()[:, 0] <= 0.01
    kept = np.flatnonzero(keep[inv.numpy()] & close.numpy())
    if not kept.size:
        raise Filtered(MESSAGES[2])
    out = {}
    for r, (car, caa) in enumerate(combos):
        if keep[r]:
            d = car + caa
            c = math.factorial(d) / (math.factorial(caa)
                                     * math.factorial(car))
            rp = torch.tensor([c * ((1.0 - e) ** car) * (e ** caa),
                               c * (0.5 ** d),
                               c * ((1.0 - e) ** caa) * (e ** car)],
                              dtype=_F64)
            out[(car, caa)] = (mean[r].to(_F32), rp.to(_F32))
    return kept, out


def loo_em(g0m, g1m, max_iter, tol):
    """One EM over members ``[P, S]`` (float32) at S kept sites: returns
    ``(f [S] float32, iterations)``."""
    p, s = g0m.shape
    f = torch.full((s,), 0.25, dtype=_F32)
    for it in range(max_iter):
        omf = 1.0 - f
        p0 = g0m * omf * omf
        p1 = g1m * 2.0 * f * omf
        p2 = (1.0 - g0m - g1m) * f * f
        w = (p1 + 2.0 * p2) / (2.0 * (p0 + p1 + p2))
        f_new = torch.clamp(w.sum(dim=0) / p, EM_EPS, 1.0 - EM_EPS)
        d = (f_new - f).to(_F64)
        f = f_new
        if math.sqrt(float((d * d).sum()) / s) < tol:
            return f, it + 1
    return f, max_iter


def z_sums(g0, g1, a, pairs, tabs):
    """``(W_obs, mu, var)`` float64 over kept sites: float32 ``g0``,
    ``g1``, ``a`` ``[S]`` and each site's ``(Ar, Aa)``."""
    p = torch.stack([(1.0 - a) * (1.0 - a), 2.0 * (1.0 - a) * a, a * a])
    w_obs = torch.log(g0 * p[0] + g1 * p[1] + (1.0 - g0 - g1) * p[2])
    depth = np.asarray([ar + aa for ar, aa in pairs])
    zero = (torch.zeros(3, dtype=_F32),) * 2
    terms = []
    mu = torch.zeros_like(a)
    for x in range(int(depth.max()) + 1):  # Aa = x, ascending
        valid = torch.as_tensor(depth >= x)
        mg, rp = (torch.stack(t) for t in zip(*(
            tabs[(d - x, x)] if d >= x else zero for d in depth)))
        lg = torch.log(mg[:, 0] * p[0] + mg[:, 1] * p[1] + mg[:, 2] * p[2])
        wt = rp[:, 0] * p[0] + rp[:, 1] * p[1] + rp[:, 2] * p[2]
        mu = mu + torch.where(valid, lg * wt, 0.0)
        terms.append((valid, lg, wt))
    var = torch.zeros_like(a)
    for valid, lg, wt in terms:
        var = var + torch.where(valid, (mu - lg) * (mu - lg) * wt, 0.0)
    return (w_obs.sum(dtype=_F64), mu.sum(dtype=_F64), var.sum(dtype=_F64))


def z_scores(gl, ad, inds, n_threshold=0, single_read=False, e=0.01,
             labels=None, max_iter=200, tol=1e-4, af=None, af_cols=None):
    """Reference mode with ``labels`` (``[N]`` population labels), or
    assignment mode with ``af`` (``[M, K]``) and ``af_cols`` (each
    individual's column).  Returns a dict of ``[n]`` arrays: ``z``,
    ``loci``, ``iters`` (0 in assignment mode), ``w_obs``, ``w_mu``,
    ``w_var``."""
    gl = np.asarray(gl, np.float32)
    n = len(inds)
    out = {k: np.zeros(n) for k in ("z", "w_obs", "w_mu", "w_var")}
    out["loci"] = np.zeros(n, np.int64)
    out["iters"] = np.zeros(n, np.int64)
    built = [tables(gl[:, i], ad[:, 2 * i: 2 * i + 2], n_threshold,
                    single_read, e) for i in inds]
    for j, (i, (kept, tabs)) in enumerate(zip(inds, built)):
        if labels is not None:
            members = [m for m in range(gl.shape[1])
                       if labels[m] == labels[i] and m != i]
            g0m = torch.as_tensor(gl[np.ix_(kept, members)][:, :, 0].T)
            g1m = torch.as_tensor(gl[np.ix_(kept, members)][:, :, 1].T)
            f, out["iters"][j] = loo_em(g0m.contiguous(), g1m.contiguous(),
                                        max_iter, tol)
            lo = torch.tensor(1.0 / (2.0 * (len(members) + 1)), dtype=_F32)
            a = torch.clamp(f, lo, 1.0 - lo)
        else:
            a = torch.as_tensor(np.asarray(af, np.float32)[kept, af_cols[j]])
        pairs = [tuple(p) for p in
                 np.asarray(ad[kept][:, 2 * i: 2 * i + 2]).tolist()]
        w_obs, mu, var = z_sums(torch.as_tensor(gl[kept, i, 0]),
                                torch.as_tensor(gl[kept, i, 1]), a, pairs,
                                tabs)
        out["z"][j] = float((w_obs - mu) / torch.sqrt(var))
        out["w_obs"][j], out["w_mu"][j] = float(w_obs), float(mu)
        out["w_var"][j] = float(var)
        out["loci"][j] = len(kept)
    return out
