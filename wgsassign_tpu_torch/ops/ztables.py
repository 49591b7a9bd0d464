"""The two passes over the cohort behind the z-score combo tables: the CUDA
kernels (``csrc/ztables.cu``) and their plain PyTorch twins.

For a block of ``b`` consecutive individuals (cohort columns ``col0`` to
``col0 + b``) and the allele-depth combos ``code = Ar * width + Aa``:

- :func:`combo_bins` returns ``[n_chunks, b, width**2, 4]`` float64: per
  chunk of sites, each combo's float64 sums of the float32 GL triple
  ``(g0, g1, (1 - g0) - g1)`` and its site count.  The caller adds the
  chunks (``sum(0)``, a fixed order) and, with several ranks, the ranks.
- :func:`site_filter` flags in ``mask`` (uint8 ``[b, m]`` rows) the sites
  whose combo survived and whose GL at the combo mean's argmax entry lies
  within ``tol`` of that mean, and returns ``[n_chunks, b, 2 width - 1]``
  int32 counts of the flagged sites by total depth ``Ar + Aa``.

The kernel adds a chunk's sites in site order (one thread a chunk and
individual), and so does the twin on the CPU (``index_add_`` of the
chunk's sites in order), so the per-chunk partials do not depend on
scheduling; the chunk count (:func:`chunk_count`) depends on the shapes
alone.  On the card the twin's ``index_add_`` adds with atomics, in no
fixed order.  The twins walk the chunks one at a time, so their
temporaries are a chunk's, not the cohort's.  The JAX package builds these
tables on the host per individual (``np.unique``, ``np.bincount``); no TPU
kernel stands behind them.

:func:`combo_bins` and :func:`site_filter` launch the kernels for CUDA
tensors unless ``kernel`` is False (``--no_pallas``), and run the twins
otherwise.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels

# budget of one [n_chunks, b, width**2, 4] float64 partial buffer
PARTIAL_BYTES = 512 << 20
MAX_CHUNKS = 1024
# fewest sites a chunk walks (below this the partials cost more than the
# sites they sum)
MIN_CHUNK_SITES = 256
AD_TYPES = {torch.uint8: 0, torch.int32: 1}


def chunk_count(n_sites: int, b: int, width: int) -> int:
    """Chunks of the site axis: as many as the partial buffer's budget
    allows, at most MAX_CHUNKS, each of at least MIN_CHUNK_SITES sites."""
    per_chunk = 32 * b * width * width
    by_budget = max(1, PARTIAL_BYTES // max(per_chunk, 1))
    by_sites = max(1, -(-n_sites // MIN_CHUNK_SITES))
    return int(min(MAX_CHUNKS, by_budget, by_sites))


def _chunk_sites(n_sites: int, n_chunks: int) -> int:
    return max(1, -(-n_sites // n_chunks))


def _check(ad, g0, g1, col0, b, n_sites, width):
    if ad.dtype not in AD_TYPES:
        raise ValueError(f"allele depths have dtype {ad.dtype}, expected "
                         f"one of {sorted(map(str, AD_TYPES))}")
    for name, t in (("ad", ad), ("g0", g0), ("g1", g1)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != g0.device:
            raise ValueError(f"{name} is on {t.device}, g0 on {g0.device}")
    n = g0.shape[1]
    if ad.shape[1] != 2 * n or g1.shape != g0.shape:
        raise ValueError(f"ad {tuple(ad.shape)} and GL planes "
                         f"{tuple(g0.shape)} do not pair up")
    if not (0 <= col0 and col0 + b <= n and n_sites <= g0.shape[0]
            and n_sites <= ad.shape[0] and width >= 1):
        raise ValueError(f"columns [{col0}, {col0 + b}) or {n_sites} sites "
                         f"outside the cohort {tuple(g0.shape)}")


def _split(ad, g0, g1, col0, b, lo, hi, width):
    """Per-site twins' operands over sites ``[lo, hi)``: ``(code [S, b]
    int64, depth, g [S, b, 3])``."""
    cols = slice(col0, col0 + b)
    pairs = ad[lo:hi].view(hi - lo, -1, 2)[:, cols].long()
    ar, aa = pairs[..., 0], pairs[..., 1]
    a0 = g0[lo:hi, cols]
    a1 = g1[lo:hi, cols]
    g = torch.stack([a0, a1, (1.0 - a0) - a1], dim=-1)
    return ar * width + aa, ar + aa, g


def _chunks(n_sites, b, width):
    """``(c, lo, hi)`` of each non-empty chunk of the site axis."""
    n_chunks = chunk_count(n_sites, b, width)
    step = _chunk_sites(n_sites, n_chunks)
    for c in range(n_chunks):
        lo, hi = c * step, min((c + 1) * step, n_sites)
        if lo < hi:
            yield c, lo, hi


def combo_bins_twin(ad, g0, g1, col0: int, b: int, n_sites: int,
                    width: int) -> torch.Tensor:
    r = width * width
    part = torch.zeros((chunk_count(n_sites, b, width), b * r, 4),
                       dtype=torch.float64, device=g0.device)
    offset = torch.arange(b, device=g0.device)[None, :] * r
    for c, lo, hi in _chunks(n_sites, b, width):
        code, _, g = _split(ad, g0, g1, col0, b, lo, hi, width)
        vals = torch.cat([g.to(torch.float64),
                          torch.ones(g.shape[:-1] + (1,), dtype=torch.float64,
                                     device=g.device)], dim=-1)
        # rows in site order, individuals within a site
        part[c].index_add_(0, (code + offset).reshape(-1),
                           vals.reshape(-1, 4))
    return part.view(-1, b, r, 4)


def combo_bins(ad, g0, g1, col0: int, b: int, n_sites: int, width: int,
               kernel: bool = True) -> torch.Tensor:
    """``[n_chunks, b, width**2, 4]`` float64 per-chunk combo sums (see the
    module docstring) of cohort columns ``[col0, col0 + b)`` over the first
    ``n_sites`` sites; ``ad`` is ``[m, 2N]`` uint8 or int32 and every count
    lies below ``width``."""
    _check(ad, g0, g1, col0, b, n_sites, width)
    if g0.device.type != "cuda" or not kernel:
        return combo_bins_twin(ad, g0, g1, col0, b, n_sites, width)
    n_chunks = chunk_count(n_sites, b, width)
    part = torch.zeros((n_chunks, b, width * width, 4), dtype=torch.float64,
                       device=g0.device)
    _kernels.launch("ztables_bin", g0.device, ad.data_ptr(), g0.data_ptr(),
                    g1.data_ptr(), part.data_ptr(), g0.shape[1], col0, b,
                    n_sites, width, n_chunks,
                    _chunk_sites(n_sites, n_chunks), AD_TYPES[ad.dtype])
    return part


def site_filter_twin(ad, g0, g1, col0: int, b: int, n_sites: int,
                     width: int, keepc, amax, meanv, mask, tol: float):
    rows = torch.arange(b, device=g0.device)[None, :]
    keepc, amax = keepc.bool(), amax.long()
    dcount = torch.zeros((chunk_count(n_sites, b, width), b, 2 * width - 1),
                         dtype=torch.int32, device=g0.device)
    for c, lo, hi in _chunks(n_sites, b, width):
        code, depth, g = _split(ad, g0, g1, col0, b, lo, hi, width)
        k = amax[rows, code]
        site_g = torch.gather(g, 2, k[..., None])[..., 0].to(torch.float64)
        kept = (keepc[rows, code]
                & ((meanv[rows, code] - site_g).abs() <= tol)).t()
        mask[:, lo:hi] |= kept.to(torch.uint8)
        dcount[c].scatter_add_(1, depth.t(), kept.to(torch.int32))
    return dcount


def site_filter(ad, g0, g1, col0: int, b: int, n_sites: int, width: int,
                keepc, amax, meanv, mask, tol: float,
                kernel: bool = True) -> torch.Tensor:
    """Flag the kept sites in ``mask`` (uint8, ``[b, >= n_sites]``, rows
    contiguous, zero where nothing is kept) and return the per-chunk
    ``[n_chunks, b, 2 width - 1]`` int32 counts of kept sites by depth.
    ``keepc`` and ``amax`` are uint8 ``[b, width**2]``, ``meanv`` float64
    ``[b, width**2]``."""
    _check(ad, g0, g1, col0, b, n_sites, width)
    r = width * width
    for name, t, dtype in (("keepc", keepc, torch.uint8),
                           ("amax", amax, torch.uint8),
                           ("meanv", meanv, torch.float64)):
        _kernels.check_operand(name, t, g0.device, dtype, (b, r))
    if (mask.dtype != torch.uint8 or mask.device != g0.device
            or mask.shape[0] != b or mask.shape[1] < n_sites
            or mask.stride(1) != 1):
        raise ValueError(f"mask must be uint8 rows of at least {n_sites} "
                         f"sites for {b} individuals on {g0.device}")
    if g0.device.type != "cuda" or not kernel:
        return site_filter_twin(ad, g0, g1, col0, b, n_sites, width, keepc,
                                amax, meanv, mask, tol)
    n_chunks = chunk_count(n_sites, b, width)
    dcount = torch.zeros((n_chunks, b, 2 * width - 1), dtype=torch.int32,
                         device=g0.device)
    _kernels.launch("ztables_filter", g0.device, ad.data_ptr(),
                    g0.data_ptr(), g1.data_ptr(), keepc.data_ptr(),
                    amax.data_ptr(), meanv.data_ptr(), mask.data_ptr(),
                    dcount.data_ptr(), g0.shape[1], col0, b, n_sites, width,
                    n_chunks, _chunk_sites(n_sites, n_chunks), mask.stride(0),
                    float(tol), AD_TYPES[ad.dtype])
    return dcount
