"""Synthetic cohorts with their allele depths, made on the device from the
seed: what ``--ind_ad_file`` holds beside the Beagle file.

The generative model of ``cohort.py`` (ancestral and Balding-Nichols
population frequencies, Hardy-Weinberg genotypes, ``Poisson(depth)`` reads
with error rate ``e``, GLs normalised from the binomial read likelihoods),
drawn in the same order from the same generator, with the ``(major,
minor)`` read counts from which each GL is made kept on the card as well.
The counts are ``uint8`` ``[M, 2N]``, the layout of an allele-depth file:
the GL table stops at ``cohort.MAX_DEPTH`` reads, far below 255.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.cohort import CHUNK_ELEMENTS, MAX_DEPTH, gl_table


def genotype_likelihoods_and_depths(gen: torch.Generator,
                                    pop_af: torch.Tensor, pop_of: np.ndarray,
                                    mean_depth: float, error_rate: float):
    """``(g0, g1, ad)``: float32 ``[M, N]`` GL planes and the uint8
    ``[M, 2N]`` read counts behind them (column ``2i`` the major count of
    individual i, ``2i + 1`` the minor), made in chunks of sites with the
    draws of ``cohort.genotype_likelihoods``."""
    device = pop_af.device
    m = pop_af.shape[0]
    n = len(pop_of)
    table = torch.from_numpy(gl_table(MAX_DEPTH, error_rate)).to(device)
    t0 = table[:, :, 0].reshape(-1)
    t1 = table[:, :, 1].reshape(-1)
    p_minor = torch.tensor([error_rate, 0.5, 1.0 - error_rate],
                           dtype=torch.float32, device=device)
    cols = torch.from_numpy(np.asarray(pop_of, np.int64)).to(device)
    g0 = torch.empty((m, n), dtype=torch.float32, device=device)
    g1 = torch.empty((m, n), dtype=torch.float32, device=device)
    ad = torch.empty((m, n, 2), dtype=torch.uint8, device=device)
    deepest = torch.zeros((), dtype=torch.float32, device=device)
    rows = max(1, CHUNK_ELEMENTS // max(n, 1))
    for lo in range(0, m, rows):
        hi = min(lo + rows, m)
        p = pop_af[lo:hi].index_select(1, cols)
        geno = ((torch.rand(p.shape, generator=gen, device=device) < p).long()
                + (torch.rand(p.shape, generator=gen, device=device) < p))
        depth = torch.poisson(torch.full(p.shape, float(mean_depth),
                                         device=device), generator=gen)
        minor = torch.binomial(depth, p_minor[geno], generator=gen)
        deepest = torch.maximum(deepest, depth.max())
        major = depth.clamp(max=MAX_DEPTH) - minor
        minor = minor.clamp(max=MAX_DEPTH)
        idx = major.long() * (MAX_DEPTH + 1) + minor.long()
        g0[lo:hi] = t0[idx]
        g1[lo:hi] = t1[idx]
        ad[lo:hi, :, 0] = major.to(torch.uint8)
        ad[lo:hi, :, 1] = minor.to(torch.uint8)
    if float(deepest) > MAX_DEPTH:
        raise ValueError(f"read depth {float(deepest)} exceeds the GL table "
                         f"({MAX_DEPTH})")
    return g0, g1, ad.view(m, 2 * n)
