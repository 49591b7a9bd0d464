"""Plain PyTorch reference of WGSassign's reference z-scores
(``--get_reference_z_score`` with ``--ind_ad_file``).

It follows WGSassign.py:346-384 and zscore.py / zscore_cy.pyx, one
individual i at a time:

- combos: i's sites grouped by their allele-depth pair (Ar, Aa)
  (``torch.unique``); per combo the site count and the float64 mean of the
  GL triple ``(g0, g1, (1 - g0) - g1)``;
- combo filter: total depth 1 under ``single_read_threshold``, else count
  above ``n_threshold`` and total depth not 0; at least two must survive;
  then only depths D with all D + 1 splits among the survivors;
- site filter: the site's combo survived and its GL at the combo mean's
  largest entry lies within 0.01 of that mean (float64); at least one
  site must survive;
- AF: the leave-one-out EM of i's population (i left out) on i's kept
  sites, the EM of ``reference.py`` (float32, start 0.25, stop at the first
  update whose RMSE over the kept sites is below ``tol``), clamped with the
  ``n_p - 1`` members left: ``[1/(2 n_p), 1 - 1/(2 n_p)]``.  The EMs of a
  population's individuals run together, each with its own kept sites in
  its RMSE (a site's update does not depend on other sites, so this is the
  EM on the kept sites alone);
- read probabilities of each kept combo:
  ``C(D, Aa) ((1-e)^Ar e^Aa, 0.5^D, (1-e)^Aa e^Ar)`` in float64, rounded to
  float32;
- z: per kept site with HWE prior ``P = ((1-a)^2, 2(1-a)a, a^2)``,
  ``W_obs = log(GL . P)``, and, enumerating ``Aa = 0..D`` with
  ``lg = log(meanGL(D - Aa, Aa) . P)`` and ``wt = readProb(D - Aa, Aa) . P``,
  ``mu = sum wt lg`` and ``var = sum wt (mu - lg)^2``; the per-site terms in
  float32, their sums over the kept sites in float64 (the precision the
  configuration states); ``z = (W_obs - mu) / sqrt(var)``.

Everything runs on the device of its inputs; the EM is blocked by sites so
its temporaries stay within ``reference.BLOCK_ELEMENTS``.  ``em_round``
rounds the EM weights before the member sums and ``sum_dtype`` sets the z
sums' type: the control's lower precisions (``reference.round_tf32``,
float32).

This module imports neither JAX, nor the JAX package, nor the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import (
    BLOCK_ELEMENTS,
    EM_EPS,
    em_weight_x2,
)

GL_MEAN_TOLERANCE = 0.01
_F32 = torch.float32
_F64 = torch.float64


class Filtered(Exception):
    """An individual whose filters leave too little (the reference raises)."""


def individual_tables(ar, aa, g0, g1, n_threshold: int, single_read: bool,
                      e: float):
    """One individual's combos and site filter.  ``ar``/``aa`` int64 and
    ``g0``/``g1`` float32, ``[M]`` each.  Returns ``(kept [M] bool,
    mean_gl [W, W, 3] float32, read_probs [W, W, 3] float32)``, the tables
    indexed by ``(Ar, Aa)`` (zero where the combo was not kept)."""
    dev = g0.device
    g = torch.stack([g0, g1, (1.0 - g0) - g1], dim=1)
    width = int(torch.maximum(ar.max(), aa.max())) + 1
    uniq, inv, counts = torch.unique(ar * width + aa, return_inverse=True,
                                     return_counts=True)
    sums = torch.zeros((len(uniq), 3), dtype=_F64, device=dev)
    sums.index_add_(0, inv, g.to(_F64))
    mean = sums / counts[:, None].to(_F64)
    u_ar, u_aa = uniq // width, uniq % width
    tot = u_ar + u_aa
    keep = (tot == 1) if single_read else (counts > n_threshold) & (tot != 0)
    if int(keep.sum()) < 2:
        raise Filtered("not enough combos")
    classes, per_class = torch.unique(tot[keep], return_counts=True)
    full = classes[classes < per_class]
    keep &= torch.isin(tot, full)
    if int(keep.sum()) == 0:
        raise Filtered("no complete depth class")
    top = mean.argmax(dim=1)
    site_val = g.gather(1, top[inv][:, None])[:, 0].to(_F64)
    mean_val = mean.gather(1, top[:, None])[:, 0][inv]
    kept = keep[inv] & ((mean_val - site_val).abs() <= GL_MEAN_TOLERANCE)
    if int(kept.sum()) == 0:
        raise Filtered("no loci")
    mean_gl = torch.zeros((width, width, 3), dtype=_F32, device=dev)
    read_probs = torch.zeros((width, width, 3), dtype=_F32, device=dev)
    k_ar, k_aa = u_ar[keep], u_aa[keep]
    mean_gl[k_ar, k_aa] = mean[keep].to(_F32)
    probs = []
    for car, caa in zip(k_ar.tolist(), k_aa.tolist()):
        d = car + caa
        c = float(math.comb(d, caa))
        probs.append((c * ((1.0 - e) ** car) * (e ** caa), c * (0.5 ** d),
                      c * ((1.0 - e) ** caa) * (e ** car)))
    read_probs[k_ar, k_aa] = torch.tensor(probs, dtype=_F64,
                                          device=dev).to(_F32)
    return kept, mean_gl, read_probs


def masked_loo_em(g0p, g1p, leave, kept, max_iter: int, tol: float,
                  em_round=None):
    """The leave-one-out EMs of one population on its ``[n, M]`` member
    panels: problem j leaves member ``leave[j]`` out and measures its RMSE
    over the sites where ``kept[j]`` is true.  Returns ``(f [G, M] float32
    unclamped, iters [G])``."""
    n, m = g0p.shape
    g = len(leave)
    dev = g0p.device
    f = torch.full((g, m), 0.25, dtype=_F32, device=dev)
    weight = kept.to(_F64)
    n_kept = kept.sum(dim=1).cpu().numpy().astype(np.float64)
    out_of = torch.zeros((n, g), dtype=torch.bool, device=dev)
    out_of[torch.as_tensor(leave, device=dev),
           torch.arange(g, device=dev)] = True
    active = np.ones(g, bool)
    iters = np.full(g, max_iter, np.int64)
    step = max(1, BLOCK_ELEMENTS // (n * g))
    for it in range(max_iter):
        if not active.any():
            break
        act = torch.from_numpy(active).to(dev)[:, None]
        f_new = torch.empty_like(f)
        sq = torch.zeros(g, dtype=_F64, device=dev)
        for lo in range(0, m, step):
            hi = min(lo + step, m)
            fb = f[:, lo:hi]
            # [member i, problem j, site]
            w2 = em_weight_x2(g0p[:, None, lo:hi], g1p[:, None, lo:hi],
                              fb[None, :, :])
            w2.masked_fill_(out_of[:, :, None], 0.0)
            if em_round is not None:
                w2 = em_round(w2)
            upd = w2.sum(dim=0) * 0.5 / (n - 1.0)
            upd = torch.where(act, upd.clamp(EM_EPS, 1.0 - EM_EPS), fb)
            d = (upd - fb).to(_F64)
            sq += (d * d * weight[:, lo:hi]).sum(dim=1)
            f_new[:, lo:hi] = upd
        f = f_new
        rmse = np.sqrt(sq.cpu().numpy() / np.maximum(n_kept, 1.0))
        crossed = active & (rmse < tol)
        iters[crossed] = it + 1
        active &= ~crossed
    return f, iters


def z_sums(g0, g1, a, depth, mean_gl, read_probs, sum_dtype=_F64):
    """``(W_obs, mu, var)`` of one individual over its kept sites (``[S]``
    GLs, AF and total depths), per-site terms in float32."""
    width = mean_gl.shape[0]
    p = torch.stack([(1.0 - a) * (1.0 - a), 2.0 * (1.0 - a) * a, a * a])
    w_obs = torch.log(g0 * p[0] + g1 * p[1] + ((1.0 - g0) - g1) * p[2])
    lgs = []
    mu = torch.zeros_like(a)
    for x in range(int(depth.max()) + 1):
        valid = depth >= x
        r = (depth - x).clamp(min=0, max=width - 1)
        c = min(x, width - 1)
        mg, rp = mean_gl[r, c], read_probs[r, c]
        lg = torch.log(mg[:, 0] * p[0] + mg[:, 1] * p[1] + mg[:, 2] * p[2])
        wt = rp[:, 0] * p[0] + rp[:, 1] * p[1] + rp[:, 2] * p[2]
        mu = mu + torch.where(valid, lg * wt, 0.0)
        lgs.append((valid, lg, wt))
    var = torch.zeros_like(a)
    for valid, lg, wt in lgs:
        var = var + torch.where(valid, (mu - lg) * (mu - lg) * wt, 0.0)
    return (w_obs.sum(dtype=sum_dtype), mu.sum(dtype=sum_dtype),
            var.sum(dtype=sum_dtype))


def reference_z(g0, g1, ad, pop_index, inds, n_threshold: int,
                single_read: bool, max_iter: int, tol: float, e: float,
                em_round=None, sum_dtype=_F64):
    """Reference z-scores of individuals ``inds`` of the ``[M, N]`` GL
    planes and ``[M, 2N]`` allele depths.  Returns ``(z [n] float64,
    loci [n], iters [n])``; an individual whose filters leave too little
    gets z NaN, loci 0 and iters -1."""
    pop_index = np.asarray(pop_index)
    inds = list(inds)
    n = len(inds)
    z = np.full(n, np.nan)
    loci = np.zeros(n, np.int64)
    iters = np.full(n, -1, np.int64)
    tables = {}
    for j, i in enumerate(inds):
        ar, aa = ad[:, 2 * i].long(), ad[:, 2 * i + 1].long()
        try:
            tables[i] = individual_tables(ar, aa, g0[:, i], g1[:, i],
                                          n_threshold, single_read, e)
        except Filtered:
            continue
        loci[j] = int(tables[i][0].sum())
    for p in np.unique(pop_index[inds]):
        members = np.flatnonzero(pop_index == p)
        probs = [i for i in inds if pop_index[i] == p and i in tables]
        if not probs:
            continue
        cols = torch.from_numpy(members).to(g0.device)
        g0p = g0.index_select(1, cols).t().contiguous()
        g1p = g1.index_select(1, cols).t().contiguous()
        kept = torch.stack([tables[i][0] for i in probs])
        leave = [int(np.flatnonzero(members == i)[0]) for i in probs]
        f, its = masked_loo_em(g0p, g1p, leave, kept, max_iter, tol,
                               em_round)
        del g0p, g1p
        lo = torch.tensor(1.0 / (2.0 * len(members)), dtype=_F32,
                          device=g0.device)
        for row, i in enumerate(probs):
            j = inds.index(i)
            keep, mean_gl, read_probs = tables[i]
            sites = torch.nonzero(keep)[:, 0]
            a = f[row].index_select(0, sites).clamp(lo, 1.0 - lo)
            depth = (ad[sites, 2 * i].long() + ad[sites, 2 * i + 1].long())
            w_obs, mu, var = z_sums(g0[sites, i], g1[sites, i], a, depth,
                                    mean_gl, read_probs, sum_dtype)
            z[j] = float((w_obs.double() - mu.double())
                         / torch.sqrt(var.double()))
            iters[j] = int(its[row])
    return z, loci, iters
