"""Synthetic genotype-likelihood cohorts, made on the device from the seed.

The generative model of WGSassign's bundled ``amre`` data, as the port's
``io/synth.py`` writes it in host NumPy, rewritten here in PyTorch so that
a 5M x 180 cohort is made on the card in a few large calls:

- per site an ancestral allele frequency ``U(0.05, 0.95)``;
- per population a Balding-Nichols frequency
  ``Beta(anc (1 - F) / F, (1 - anc) (1 - F) / F)``;
- per individual a Hardy-Weinberg genotype at its population's frequency;
- ``Poisson(depth)`` reads, each a minor allele with probability ``e``,
  1/2 or ``1 - e`` for genotype 0, 1 or 2;
- GLs proportional to the binomial read likelihoods, normalised
  (``gl_table``).

Every draw comes from one ``torch.Generator`` seeded with the run's seed,
in a fixed order, so the same seed gives the same cohort on the same
device.
"""

from __future__ import annotations

import numpy as np
import torch

# Poisson(2) exceeds this with probability ~1e-71; a larger depth raises.
MAX_DEPTH = 64
# elements per generation chunk (a few temporaries of this size coexist)
CHUNK_ELEMENTS = 1 << 25


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` for any whole-number seed (negative or
    wider than 64 bits too: it is taken modulo 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def gl_table(max_depth: int, error_rate: float) -> np.ndarray:
    """``[D + 1, D + 1, 2]`` float32: the normalised (GL0, GL1) of every
    (major, minor) read-count pair (the likelihood depends on the counts
    alone)."""
    maj, mino = np.meshgrid(np.arange(max_depth + 1),
                            np.arange(max_depth + 1), indexing="ij")
    e = error_rate
    l0 = (1 - e) ** maj * e ** mino
    l1 = 0.5 ** (maj + mino).astype(np.float64)
    l2 = e ** maj * (1 - e) ** mino
    tot = l0 + l1 + l2
    table = np.empty((max_depth + 1, max_depth + 1, 2), dtype=np.float32)
    table[:, :, 0] = l0 / tot
    table[:, :, 1] = l1 / tot
    return table


def population_af(gen: torch.Generator, m: int, k: int, fst: float,
                  device) -> torch.Tensor:
    """``[M, K]`` float32 population allele frequencies."""
    anc = 0.05 + 0.9 * torch.rand(m, generator=gen, device=device)
    scale = (1.0 - fst) / fst
    a = (anc * scale)[:, None].expand(m, k).contiguous()
    b = ((1.0 - anc) * scale)[:, None].expand(m, k).contiguous()
    x = torch._standard_gamma(a, generator=gen)
    y = torch._standard_gamma(b, generator=gen)
    return x / (x + y)


def genotype_likelihoods(gen: torch.Generator, pop_af: torch.Tensor,
                         pop_of: np.ndarray, mean_depth: float,
                         error_rate: float):
    """``(g0, g1)``, float32 ``[M, N]`` each, for individuals whose
    populations are ``pop_of`` (``[N]`` indices into ``pop_af``'s columns),
    made in chunks of sites."""
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
        idx = (depth.clamp(max=MAX_DEPTH) - minor).long() * (MAX_DEPTH + 1)
        idx += minor.clamp(max=MAX_DEPTH).long()
        g0[lo:hi] = t0[idx]
        g1[lo:hi] = t1[idx]
    if float(deepest) > MAX_DEPTH:
        raise ValueError(f"read depth {float(deepest)} exceeds the GL table "
                         f"({MAX_DEPTH})")
    return g0, g1


def population_sizes(config: dict) -> np.ndarray:
    """``[K]`` members a population, as the configuration states them
    (``population_sizes``, summing to ``individuals``)."""
    sizes = np.asarray(config["population_sizes"], np.int64)
    if len(sizes) != int(config["populations"]) or (
            int(sizes.sum()) != int(config["individuals"])):
        raise ValueError(f"population_sizes {sizes.tolist()} do not make "
                         f"{config['populations']} populations of "
                         f"{config['individuals']} individuals")
    return sizes


def population_index(sizes) -> np.ndarray:
    """``[N]`` population of each individual: the populations in blocks,
    in order (a sample sheet sorted by population)."""
    return np.repeat(np.arange(len(sizes)), np.asarray(sizes, np.int64))


def proportional_sizes(sizes, total: int) -> np.ndarray:
    """``sizes`` scaled to sum to ``total``, rounded by largest remainder
    (ties to the earlier population)."""
    sizes = np.asarray(sizes, np.float64)
    exact = sizes * total / sizes.sum()
    out = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - out), kind="stable")
    out[order[:total - int(out.sum())]] += 1
    return out


def clamp_panel(af: torch.Tensor, sizes) -> torch.Tensor:
    """Clamp column k to ``[1/(2(n+1)), 1 - 1/(2(n+1))]``, ``n`` its
    population's ``sizes[k]`` members, as a reference panel is clamped
    (WGSassign.py:236-240)."""
    n = torch.as_tensor(np.asarray(sizes, np.float32), device=af.device)
    lo = 1.0 / (2.0 * (n + 1.0))
    return torch.minimum(torch.maximum(af, lo), 1.0 - lo)
