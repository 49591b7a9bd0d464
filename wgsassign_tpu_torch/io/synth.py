"""Synthetic cohort generation at production scale.

Generates multi-million-SNP genotype-likelihood cohorts (BASELINE.json's
N-host benchmark configs) either as in-memory arrays or as a gzipped Beagle
file for end-to-end pipeline benchmarking.  The model matches the bundled
amre data's generative process: per (site, individual), true genotypes from
HWE at a per-population AF (populations get Balding-Nichols-style divergence
around an ancestral AF), reads at Poisson depth with error rate e, and GLs
proportional to the binomial read likelihoods.
"""

from __future__ import annotations

import gzip

import numpy as np


def _gl_table(max_depth: int, e: float) -> np.ndarray:
    """Normalized (GL0, GL1) for every (major, minor) read-count pair —
    the likelihood depends only on the counts, so per-element transcendental
    ops become one table gather."""
    maj, mino = np.meshgrid(
        np.arange(max_depth + 1), np.arange(max_depth + 1), indexing="ij"
    )
    l0 = (1 - e) ** maj * e**mino
    l1 = 0.5 ** (maj + mino).astype(np.float64)
    l2 = e**maj * (1 - e) ** mino
    tot = l0 + l1 + l2
    table = np.empty((max_depth + 1, max_depth + 1, 2), dtype=np.float32)
    table[:, :, 0] = l0 / tot
    table[:, :, 1] = l1 / tot
    return table


def synth_cohort(
    m_sites: int,
    n_inds: int,
    n_pops: int = 5,
    mean_depth: float = 2.0,
    error_rate: float = 0.01,
    fst: float = 0.05,
    seed: int = 0,
):
    """Returns ``(gl [M, N, 2] float32, pop_labels [N], ad [M, 2N] int32)``.

    Chunked over sites (bounds peak host memory to ~chunk*N temporaries) with
    table-lookup likelihoods — multi-million-SNP cohorts generate in seconds
    per million sites instead of minutes.
    """
    rng = np.random.default_rng(seed)
    pop_of = np.arange(n_inds) % n_pops
    gl = np.empty((m_sites, n_inds, 2), dtype=np.float32)
    ad = np.empty((m_sites, 2 * n_inds), dtype=np.int32)
    p_minor_of_geno = np.array(
        [error_rate, 0.5, 1.0 - error_rate], dtype=np.float64
    )
    table = None
    chunk = max(1, min(m_sites, (1 << 26) // max(n_inds, 1)))
    for lo in range(0, m_sites, chunk):
        hi = min(lo + chunk, m_sites)
        anc = rng.uniform(0.05, 0.95, size=hi - lo)
        a = anc * (1.0 - fst) / fst
        b = (1.0 - anc) * (1.0 - fst) / fst
        pop_af = rng.beta(a[:, None], b[:, None], size=(hi - lo, n_pops))
        geno = rng.binomial(2, pop_af[:, pop_of])  # [chunk, N]
        depth = rng.poisson(mean_depth, size=geno.shape)
        minor = rng.binomial(depth, p_minor_of_geno[geno])
        major = depth - minor
        dmax = int(depth.max()) if depth.size else 0
        if table is None or table.shape[0] <= dmax:
            table = _gl_table(max(dmax, 1), error_rate)
        gl[lo:hi] = table[major, minor]
        ad[lo:hi, 0::2] = major
        ad[lo:hi, 1::2] = minor
    labels = np.array([f"pop{p}" for p in pop_of])
    return gl, labels, ad


def write_beagle(path: str, gl: np.ndarray, compresslevel: int = 1) -> str:
    """Write ``[M, N, 2]`` GLs as a gzipped Beagle file."""
    m, n, _ = gl.shape
    g2 = 1.0 - gl[:, :, 0] - gl[:, :, 1]
    with gzip.open(path, "wt", compresslevel=compresslevel) as f:
        f.write(
            "marker\tallele1\tallele2"
            + "".join(f"\tInd{i}\tInd{i}\tInd{i}" for i in range(n))
            + "\n"
        )
        for s in range(m):
            row = np.empty(3 * n, dtype=np.float32)
            row[0::3] = gl[s, :, 0]
            row[1::3] = gl[s, :, 1]
            row[2::3] = g2[s]
            f.write(
                f"scaffold{s % 1000}_{s}\t1\t2\t"
                + "\t".join(f"{v:.6f}" for v in row)
                + "\n"
            )
    return path


def synth_beagle_file(
    path: str,
    m_sites: int,
    n_inds: int,
    n_pops: int = 5,
    seed: int = 0,
    compresslevel: int = 1,
    chunk: int = 100_000,
) -> str:
    """Write a synthetic gzipped Beagle file of arbitrary size chunk by
    chunk — peak host memory O(chunk * N), so scale-benchmark inputs far
    larger than RAM-resident matrices can be produced.

    Formatting is fully vectorized: GLs are fixed-point "%.6f" values in
    [0, 1], rendered digit-by-digit into a fixed-width uint8 byte matrix
    (the pure-Python row loop in :func:`write_beagle` is fine for test
    fixtures but ~100x too slow at benchmark scale)."""
    import gzip as _gzip

    with _gzip.open(path, "wb", compresslevel=compresslevel) as f:
        f.write(
            (
                "marker\tallele1\tallele2"
                + "".join(f"\tInd{i}\tInd{i}\tInd{i}" for i in range(n_inds))
                + "\n"
            ).encode()
        )
        for lo in range(0, m_sites, chunk):
            hi = min(lo + chunk, m_sites)
            gl, _, _ = synth_cohort(
                hi - lo, n_inds, n_pops=n_pops, seed=seed + 1 + lo
            )
            body = np.empty((hi - lo, 3 * n_inds), dtype=np.float32)
            body[:, 0::3] = gl[:, :, 0]
            body[:, 1::3] = gl[:, :, 1]
            body[:, 2::3] = 1.0 - gl[:, :, 0] - gl[:, :, 1]
            f.write(_fixed6_rows(body, lo).tobytes())
    return path


def _fixed6_rows(body: np.ndarray, row0: int) -> np.ndarray:
    """Render ``[r, c]`` floats in [0, 1] as Beagle data rows:
    ``s<10-digit site id>\t1\t2\t`` + c tab-separated "%.6f" values +
    newline, as a uint8 matrix (one fixed-width row per site)."""
    r, c = body.shape
    v = np.round(np.clip(body, 0.0, 1.0).astype(np.float32) * 1e6)
    v = v.astype(np.int32)  # 0..1_000_000
    prefix_len = 1 + 10 + 5  # "s" + id + "\t1\t2\t"
    width = prefix_len + 9 * c  # 8 chars + separator per value
    out = np.empty((r, width), dtype=np.uint8)
    # site-id prefix
    ids = np.arange(row0, row0 + r, dtype=np.int64)
    out[:, 0] = ord("s")
    for d in range(10):
        out[:, 1 + d] = 48 + (ids // 10 ** (9 - d)) % 10
    out[:, 11:16] = np.frombuffer(b"\t1\t2\t", dtype=np.uint8)
    # values: integer part, '.', six fraction digits (two 3-digit lookup
    # gathers — per-digit divmod over the full matrix is ~10x slower),
    # separator
    val = out[:, prefix_len:].reshape(r, c, 9)
    val[..., 0] = 48 + (v // 1_000_000).astype(np.uint8)
    val[..., 1] = ord(".")
    frac = v % 1_000_000
    table3 = np.empty((1000, 3), dtype=np.uint8)
    k = np.arange(1000)
    table3[:, 0] = 48 + k // 100
    table3[:, 1] = 48 + (k // 10) % 10
    table3[:, 2] = 48 + k % 10
    val[..., 2:5] = table3[frac // 1000]
    val[..., 5:8] = table3[frac % 1000]
    val[..., 8] = ord("\t")
    out[:, -1] = ord("\n")
    return out
