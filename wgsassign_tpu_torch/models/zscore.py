"""Assignment z-scores (``--get_reference_z_score`` /
``--get_assignment_z_score``).

Counterpart of ``wgsassign_tpu/models/zscore.py``, same semantics
(reference WGSassign.py:346-384, 425-446).  Per individual i:

1. Group sites by i's allele-depth combo (Ar, Aa); per combo record the
   count and mean GL triple.                               [host, numpy]
2. Filter combos: ``single_read`` keeps total-depth-1 combos; otherwise
   count > threshold and depth != 0; then keep only depths D whose combo
   count exceeds D (all D+1 splits observed).              [host]
3. Keep sites whose combo survived and whose GL at the combo mean's argmax
   entry is within 0.01 of that mean.                      [host, numpy]
4. AF at kept sites: reference mode re-runs the LOO EM of i's population on
   i's kept sites; assignment mode takes the saved AF panel's column of i's
   *assigned* population.                                  [device]
5. Binomial read-probability tables with error rate e = 0.01; observed,
   expected and variance sums; Z = (W_obs - mu) / sqrt(var).  [device]

The host tables (steps 1-3) are the JAX package's numpy code, copied
because ``wgsassign_tpu.models`` imports jax.  Reference mode runs its
per-individual EMs in one of two structures, chosen once per run by the
kept fraction ``fill`` exactly as the JAX package chooses on one device:
loo-structured (``zloo_chunk`` kernel, full site axis) when ``fill >= 0.5``,
gathered (``sites_chunk`` kernel, kept sites only) otherwise.  Under
``--no_pallas`` the plain ops of ``ops/emmaf.py`` run in the same structure
instead; ``ZScoreResult.engine`` says which ran.

With several ranks every rank builds the host tables whole (they are global
per individual: the allele-depth file is read in full and the GL columns are
gathered across the ranks), then keeps of each individual's kept sites those
in its window of the site axis (:func:`_localize`).  The EM is always
loo-structured then, as in the JAX package on several devices; its
convergence partials and the three z sums are added over the ranks before
``z`` is formed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import PopulationMap
from wgsassign_tpu_torch.models.common import (
    DeviceCohort,
    local_rows,
    to_device,
)
from wgsassign_tpu_torch.models.loo import _member_panels
from wgsassign_tpu_torch.ops.emmaf import em_maf_loo_subset, em_maf_sites_batch
from wgsassign_tpu_torch.ops.fused_em import (
    em_maf_loo_subset_fused,
    em_maf_sites_batch_fused,
)
from wgsassign_tpu_torch.ops.sites_chunk import sites_chunk
from wgsassign_tpu_torch.ops.zloo_chunk import zloo_chunk
from wgsassign_tpu_torch.ops.zscore_ops import zscore_sums_batch_compact
from wgsassign_tpu_torch.parallel.runtime import (
    PAD_AF,
    Runtime,
    synchronize,
)

F32 = np.float32

SEQ_ERROR_RATE = 0.01       # hard-coded in the reference (WGSassign.py:350,430)
GL_MEAN_TOLERANCE = 0.01    # hard-coded in the reference (zscore.py:55)

# Device-memory budgets, sized for an 80 GB H100 (PERF.md).  Z_BLOCK_BYTES
# bounds one z-sums block: at ~256 bytes per kept-site slot and individual
# (inputs, the per-split lg/wt rows kept between the two passes, gather
# temporaries) it holds 32 individuals at 1M kept-site slots.
Z_BLOCK_BYTES = 8 << 30
# One AF/EM group: the individuals whose kept-site AF panels (reference
# mode: whose LOO EMs) are produced by one af_block_fn call.  Its AF panel
# stays resident through all of the group's z-sums blocks.
AF_GROUP_BYTES = 4 << 30
AF_GROUP_MAX_INDS = 64

# Kept fraction at or above which reference mode takes the loo-structured
# EM (the JAX package's single-device rule, models/zscore.py:744).
LOO_STRUCTURED_FILL = 0.5


@dataclass
class ComboTables:
    """Per-individual combo grouping + site filter result."""

    combos: np.ndarray      # int64 [R, 2] kept (Ar, Aa) combos
    mean_gl: np.ndarray     # float32 [R, 3] mean GL triple per combo
    read_probs: np.ndarray  # float32 [R, 3] P(reads | genotype)
    keep_sites: np.ndarray  # int64 [S] kept site indices (ascending)
    site_row: np.ndarray    # int32 [S] combo row per kept site
    site_depth: np.ndarray  # int64 [S] total depth per kept site
    g0_keep: np.ndarray     # float32 [S] the individual's GL(g=0) at kept sites
    g1_keep: np.ndarray     # float32 [S] the individual's GL(g=1) at kept sites
    # kept sites over the whole site axis, where the per-site fields hold
    # only one rank's window (:func:`_localize`); None: they hold all
    n_kept_global: Optional[int] = None

    @property
    def n_kept(self) -> int:
        """Kept sites over the whole site axis (the EM's RMSE denominator,
        the reported loci count)."""
        if self.n_kept_global is None:
            return int(self.keep_sites.size)
        return self.n_kept_global


class FilteringError(ValueError):
    pass


def build_combo_tables(
    gl_i: np.ndarray,
    ad_i: np.ndarray,
    n_threshold: int,
    single_read_threshold: bool,
    e: float = SEQ_ERROR_RATE,
) -> ComboTables:
    """Steps 1-3 + the read-probability table, vectorized on host.

    Args:
      gl_i: float32 ``[M, 2]`` -- (g0, g1) of the individual.
      ad_i: int ``[M, 2]`` -- (major, minor) read counts of the individual.
    """
    g0 = gl_i[:, 0].astype(F32)
    g1 = gl_i[:, 1].astype(F32)
    g2 = (1.0 - g0 - g1).astype(F32)
    ar = ad_i[:, 0].astype(np.int64)
    aa = ad_i[:, 1].astype(np.int64)
    width = int(aa.max()) + 1 if aa.size else 1
    code = ar * width + aa
    uniq, inv, counts = np.unique(code, return_inverse=True, return_counts=True)
    r_all = len(uniq)
    mean_gl = np.zeros((r_all, 3), dtype=np.float64)
    for gi, g in enumerate((g0, g1, g2)):
        mean_gl[:, gi] = np.bincount(inv, weights=g.astype(np.float64), minlength=r_all)
    mean_gl /= counts[:, None]
    combos = np.stack([uniq // width, uniq % width], axis=1)
    totals = combos.sum(axis=1)

    if single_read_threshold:
        keep = totals == 1
    else:
        keep = (counts > n_threshold) & (totals != 0)
    if keep.sum() < 2:
        raise FilteringError(
            "Not enough allele-count combinations were kept! Too stringent filtering?"
        )
    # keep only depths where all D+1 splits were observed among kept combos
    kept_tot = totals[keep]
    dl, dl_counts = np.unique(kept_tot, return_counts=True)
    dl_keep = dl[dl < dl_counts]
    keep &= np.isin(totals, dl_keep)
    if keep.sum() == 0:
        raise FilteringError(
            "No complete depth classes survived filtering (no depth has all "
            "of its allele-count splits observed)"
        )

    # site filter: combo kept AND |GL - comboMean| <= tol at the mean's argmax
    site_combo_kept = keep[inv]
    max_id = mean_gl.argmax(axis=1)
    gl3 = np.stack([g0, g1, g2], axis=1).astype(np.float64)
    site_val = gl3[np.arange(len(inv)), max_id[inv]]
    mean_val = mean_gl[inv, max_id[inv]]
    site_ok = np.abs(mean_val - site_val) <= GL_MEAN_TOLERANCE
    keep_sites = np.flatnonzero(site_combo_kept & site_ok)
    if keep_sites.size == 0:
        raise FilteringError("No loci were kept! Too stringent filtering?")

    # compact row numbering over kept combos only
    old_rows = np.flatnonzero(keep)
    new_row_of = -np.ones(r_all, dtype=np.int32)
    new_row_of[old_rows] = np.arange(len(old_rows), dtype=np.int32)
    site_row = new_row_of[inv[keep_sites]]

    kept_combos = combos[old_rows]
    read_probs = np.zeros((len(old_rows), 3), dtype=F32)
    for r, (car, caa) in enumerate(kept_combos):
        d = int(car + caa)
        c = math.factorial(d) / (math.factorial(int(caa)) * math.factorial(int(car)))
        read_probs[r, 0] = c * ((1.0 - e) ** car) * (e**caa)
        read_probs[r, 1] = c * (0.5**d)
        read_probs[r, 2] = c * ((1.0 - e) ** caa) * (e**car)

    return ComboTables(
        combos=kept_combos,
        mean_gl=mean_gl[old_rows].astype(F32),
        read_probs=read_probs,
        keep_sites=keep_sites,
        site_row=site_row,
        site_depth=totals[inv[keep_sites]],
        g0_keep=np.ascontiguousarray(g0[keep_sites]),
        g1_keep=np.ascontiguousarray(g1[keep_sites]),
    )


def _bucket(n: int, mult: int) -> int:
    """Round up to the next power of two, then to a multiple of ``mult``
    (few distinct padded sizes across runs)."""
    n = max(n, 1)
    size = 1 << (n - 1).bit_length()
    return -(-max(size, mult) // mult) * mult


def _split_tables(tables: ComboTables) -> np.ndarray:
    """Per-depth split enumeration ``rows_by_depth [D_max+1, C]``: the
    combo-table row of split ``(d-x, x)`` for each kept depth ``d``.  All
    splits exist by the depth-class filter; the validity mask is just
    ``x <= d``, derived on device."""
    row_of = {
        (int(a), int(b)): r for r, (a, b) in enumerate(tables.combos)
    }
    depths = np.unique(tables.site_depth)
    c_max = int(depths.max()) + 1
    rows_by_depth = np.zeros((c_max, c_max), dtype=np.int32)
    for d in depths:
        for x in range(int(d) + 1):
            rows_by_depth[d, x] = row_of[(int(d - x), int(x))]
    return rows_by_depth


@dataclass
class ZScoreResult:
    z: np.ndarray           # float32 [n_sub]
    loci: np.ndarray        # int32 [n_sub] kept-site counts
    w_obs: np.ndarray       # float32 [n_sub]
    w_mu: np.ndarray        # float32 [n_sub]
    w_var: np.ndarray       # float32 [n_sub]
    # reference mode: each individual's LOO EM convergence iteration (0 in
    # assignment mode, which runs no EM)
    em_iters: np.ndarray    # int32 [n_sub]
    fill: float = 0.0       # kept fraction over the individual range
    structure: str = ""     # "loo-structured", "gathered" or "assignment"
    # reference mode: what ran the EMs -- "zloo_chunk" or "sites_chunk" (the
    # chunked EM), or "plain" (the plain op, under --no_pallas)
    engine: str = ""


@dataclass
class _ZBlock:
    """Host-assembled batched operands for one block of B individuals.

    Per-individual combo tables are padded to shapes shared across the
    whole ``[ind_start, ind_end)`` range; the final partial block is padded
    with repeats of its last individual, whose results are discarded.  The
    per-site GLs, site weights, split tables and AF values are derived on
    the device from ``keep``/``depth``/``s_real`` and the small combo
    tables."""

    inds: List[int]          # real individual index per slot (repeats pad)
    n_real: int              # number of non-repeated leading slots
    keep: np.ndarray         # int32 [B, S] kept-site indices (pad -> 0)
    s_real: np.ndarray       # float32 [B] kept-site counts (in this window)
    s_glob: np.ndarray       # float32 [B] kept-site counts over all windows
    depth: np.ndarray        # int32 [B, S] total depth per kept site (pad 0)
    rows_by_depth: np.ndarray  # int32 [B, C, C] combo row of split x at depth d
    like_tab: np.ndarray     # float32 [B, R, 3]
    fact_tab: np.ndarray     # float32 [B, R, 3]

    @functools.cached_property
    def weight(self) -> np.ndarray:
        """float32 [B, S] -- 1.0 on the first ``s_real`` kept-site slots."""
        s_pad = self.keep.shape[1]
        return (
            np.arange(s_pad)[None, :] < self.s_real[:, None]
        ).astype(F32)


def _gl_column_iter(beagle, cohort, inds, chunk: Optional[int] = None):
    """Yield ``(i, gl_i [M_real, 2] float32)`` per individual.

    From the host parse when it is resident (a :class:`BeagleData`);
    otherwise (``--stream_ingest``: the GL matrix exists only on the
    device) the columns are gathered from the device cohort ``chunk``
    individuals at a time, ~256 MB per copy to the host.  With several
    ranks each holds only its window of the rows, so the columns always
    come from the device cohorts, gathered across the ranks to every rank
    (counterpart of ``fetch_to_host(cols)`` in the JAX package)."""
    rt = cohort.runtime
    if isinstance(beagle, BeagleData) and rt.world == 1:
        for i in inds:
            yield i, beagle.gl[:, i, :]
        return
    m_real = cohort.m_real
    if chunk is None:
        chunk = max(1, (1 << 28) // (8 * max(m_real, 1)))
    dev = rt.device
    for lo in range(0, len(inds), chunk):
        block = list(inds[lo : lo + chunk])
        idx = _put(np.asarray(block, np.int64), dev)
        cols = torch.stack([cohort.g0.index_select(1, idx),
                            cohort.g1.index_select(1, idx)], dim=-1)
        cols = rt.gather_sites(cols, to_all=True)[:m_real].cpu().numpy()
        # [M_real, B, 2]
        for bi, i in enumerate(block):
            yield i, cols[:, bi, :]


def _prepare_tables(beagle, cohort, ad, inds, n_threshold,
                    single_read_threshold, error_rate=SEQ_ERROR_RATE):
    """Combo tables + split enumerations for every individual in the range,
    and the shared padded shapes.

    Individuals build concurrently on a host thread pool (numpy's sort and
    bincount passes release the GIL); a bounded in-flight window keeps peak
    memory at O(workers) GL columns, not O(N).  Failures surface in
    individual order, as in a serial loop.  The GL columns come from
    :func:`_gl_column_iter`.  ``s_max`` is the largest kept-site count in
    this rank's window (the shape of its arrays), ``s_max_global`` the
    largest over the whole site axis (the same on every rank: the block
    sizes come from it, so the ranks walk the same blocks)."""
    tables, splits = {}, {}

    def build(i, gl_i):
        t = build_combo_tables(
            gl_i, ad[:, 2 * i : 2 * i + 2],
            n_threshold, single_read_threshold, e=error_rate,
        )
        return i, t, _split_tables(t)

    workers = min(max(os.cpu_count() or 1, 1), 8)

    def drain(fut):
        i, t, sp = fut.result()
        tables[i] = t
        splits[i] = sp

    pending = deque()
    with ThreadPoolExecutor(workers) as pool:
        for i, gl_i in _gl_column_iter(beagle, cohort, inds):
            pending.append(pool.submit(build, i, gl_i))
            while len(pending) > 2 * workers:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
    if cohort.runtime.world > 1:
        tables = {i: _localize(t, cohort.lo, cohort.hi)
                  for i, t in tables.items()}
    s_max = max(t.keep_sites.size for t in tables.values())
    s_max_global = max(t.n_kept for t in tables.values())
    c_max = max(r.shape[1] for r in splits.values())
    r_max = max(len(t.combos) for t in tables.values())
    return tables, splits, s_max, s_max_global, c_max, r_max


def _localize(t: ComboTables, lo: int, hi: int) -> ComboTables:
    """The tables of one individual with the per-site fields cut to the
    kept sites in the window ``[lo, hi)`` of the site axis, shifted by
    ``lo``.  Kept sites ascend, so the window is one slice of them."""
    a, b = np.searchsorted(t.keep_sites, (lo, hi))
    return dataclasses.replace(
        t, keep_sites=t.keep_sites[a:b] - lo, site_row=t.site_row[a:b],
        site_depth=t.site_depth[a:b], g0_keep=t.g0_keep[a:b],
        g1_keep=t.g1_keep[a:b], n_kept_global=int(t.keep_sites.size),
    )


def _assemble_block(tables, splits, inds, b_pad, s_pad, c_pad, r_pad):
    n_real = len(inds)
    slots = list(inds) + [inds[-1]] * (b_pad - n_real)
    keep = np.zeros((b_pad, s_pad), dtype=np.int32)
    s_real = np.zeros((b_pad,), dtype=F32)
    s_glob = np.zeros((b_pad,), dtype=F32)
    depth = np.zeros((b_pad, s_pad), dtype=np.int32)
    rows_by_depth = np.zeros((b_pad, c_pad, c_pad), dtype=np.int32)
    # padded combo rows carry a harmless valid triple; they are never
    # gathered (rows_by_depth only references real rows) but stay finite.
    like_tab = np.zeros((b_pad, r_pad, 3), dtype=F32)
    like_tab[:, :, 0] = 1.0
    fact_tab = np.zeros((b_pad, r_pad, 3), dtype=F32)
    for slot, i in enumerate(slots):
        t = tables[i]
        s = t.keep_sites.size
        keep[slot, :s] = t.keep_sites
        s_real[slot] = s
        s_glob[slot] = t.n_kept
        depth[slot, :s] = t.site_depth
        rbd = splits[i]
        rows_by_depth[slot, : rbd.shape[0], : rbd.shape[1]] = rbd
        like_tab[slot, : len(t.combos)] = t.mean_gl
        fact_tab[slot, : len(t.combos)] = t.read_probs
    return _ZBlock(
        inds=slots, n_real=n_real, keep=keep, s_real=s_real, s_glob=s_glob,
        depth=depth,
        rows_by_depth=rows_by_depth, like_tab=like_tab, fact_tab=fact_tab,
    )


# --- device helpers (torch indexing on cohort.runtime.device) --------------

def _put(a, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _gather_block_inputs(cohort, keep, inds, s_real):
    """The individuals' GLs at their kept sites (a ``[B, S]`` cohort
    gather) and the kept-slot weight mask (from ``s_real``)."""
    dev = cohort.runtime.device
    k = _put(keep, dev, torch.long)
    cols = _put(inds, dev, torch.long)[:, None]
    sr = _put(s_real, dev, torch.float32)
    w = (torch.arange(k.shape[1], device=dev)[None, :]
         < sr[:, None]).to(torch.float32)
    return cohort.g0[k, cols], cohort.g1[k, cols], w


def _gather_af_block(af_dev, keep, cols):
    """Assignment-mode AF at kept sites: ``[M, K] -> [B, S]``."""
    dev = af_dev.device
    return af_dev[_put(keep, dev, torch.long),
                  _put(cols, dev, torch.long)[:, None]]


def _scatter_site_weight(keep, weight, m_pad, device):
    """``[G, m_pad]`` kept-site mask from kept-site indices (padded slots
    carry index 0 with weight 0, so adding them changes nothing)."""
    k = _put(keep, device, torch.long)
    out = torch.zeros((k.shape[0], m_pad), dtype=torch.float32, device=device)
    return out.scatter_add_(1, k, _put(weight, device, torch.float32))


def _gather_kept_af(f, keep, min_val):
    """Clamped AF at each problem's kept sites: ``[G, M] -> [G, S]``;
    ``min_val`` is rounded to float32 first, as the JAX package does."""
    mv = torch.tensor(min_val, dtype=torch.float32, device=f.device)
    kept = torch.gather(f, 1, _put(keep, f.device, torch.long))
    return torch.clamp(kept, mv, 1.0 - mv)


def _gather_member_panels(g0, g1, keep, mem):
    """Each problem's member GLs at its kept sites: ``[M, N] -> [B, P, S]``."""
    dev = g0.device
    k = _put(keep, dev, torch.long)[:, None, :]
    m = _put(mem, dev, torch.long)[:, :, None]
    return g0[k, m], g1[k, m]


def _clamp_loo_af(f, mem_mask):
    """Reference clamp with n = LOO member count (WGSassign.py:358-364)."""
    counts = torch.sum(mem_mask, dim=1)
    min_val = (1.0 / (2.0 * (counts + 1.0)))[:, None]
    return torch.clamp(f, min_val, 1.0 - min_val)


def _run_blocks(
    cohort, beagle, ad, ind_start, ind_end, af_block_fn, per_ind_bytes_extra,
    n_threshold, single_read_threshold, verbose, block_bytes=None,
    error_rate=SEQ_ERROR_RATE, timer=None,
    sums_op=zscore_sums_batch_compact,
):
    """Shared batched driver.  ``af_block_fn(block, fill)`` returns a
    device ``[B, S]`` AF panel for the block's kept sites and the ``[B]``
    EM iteration counts behind it.  With a ``timer``
    (:class:`wgsassign_tpu_torch.obs.profiling.RunTimer`) the host tables, the
    AF groups and the z-sums blocks are timed as the phases
    ``zscore_tables``, ``zscore_af`` and ``zscore_sums``.  ``sums_op``
    computes a block's three z sums."""
    dev = cohort.runtime.device

    def phase(name):
        return (timer.phase(name) if timer is not None
                else contextlib.nullcontext())

    inds = list(range(ind_start, ind_end))
    out = _empty_result(len(inds))
    if not inds:
        return out
    with phase("zscore_tables"):
        tables, splits, s_max, s_max_global, c_max, r_max = _prepare_tables(
            beagle, cohort, ad, inds, n_threshold, single_read_threshold,
            error_rate,
        )
    s_pad = _bucket(s_max, 1)
    s_size = _bucket(s_max_global, 1)  # == s_pad with one rank
    c_pad = _bucket(c_max, 4)
    r_pad = _bucket(r_max, 4)
    per_ind = s_size * 256
    budget = Z_BLOCK_BYTES if block_bytes is None else block_bytes
    b = int(max(1, min(len(inds), budget // max(per_ind, 1))))

    # AF/EM group size, decoupled from the z-sums block size: a population's
    # problems share one batched EM drive for many z-sums blocks.  ``fill``
    # (kept fraction over the whole range) also fixes the reference-mode EM
    # structure for every block of the run.
    fill = float(
        sum(t.n_kept for t in tables.values())
    ) / max(len(inds) * max(cohort.m_real, 1), 1)
    out.fill = fill
    per_ind_af = max(per_ind_bytes_extra(s_size, fill), 4 * s_size)
    b_af = int(max(b, min(
        len(inds), AF_GROUP_MAX_INDS, AF_GROUP_BYTES // per_ind_af
    )))

    for glo in range(0, len(inds), b_af):
        g_inds = inds[glo : glo + b_af]
        g_block = _assemble_block(
            tables, splits, g_inds, len(g_inds), s_pad, c_pad, r_pad
        )
        with phase("zscore_af"):
            af_group, g_iters = af_block_fn(g_block, fill)
            synchronize(dev)
        out.em_iters[glo : glo + len(g_inds)] = g_iters
        for lo in range(0, len(g_inds), b):
            chunk = g_inds[lo : lo + b]
            block = _assemble_block(
                tables, splits, chunk, b, s_pad, c_pad, r_pad
            )
            rows = np.arange(lo, lo + len(chunk), dtype=np.int64)
            if len(chunk) < b:  # padded slots repeat the last real row
                rows = np.concatenate(
                    [rows, np.full(b - len(chunk), rows[-1], np.int64)]
                )
            with phase("zscore_sums"):
                a_dev = af_group.index_select(0, _put(rows, dev))
                g0k_d, g1k_d, w_d = _gather_block_inputs(
                    cohort, block.keep, block.inds, block.s_real,
                )
                sums = sums_op(
                    g0k_d, g1k_d, a_dev, w_d,
                    _put(block.depth, dev), _put(block.rows_by_depth, dev),
                    _put(block.like_tab, dev), _put(block.fact_tab, dev),
                )
                # float64 before the sum over the ranks, as on one rank
                # before ``z`` is formed
                w_obs, w_mu, w_var = cohort.runtime.all_reduce_sum(
                    torch.stack(sums).to(torch.float64)).cpu().numpy()
            for slot in range(block.n_real):
                pos = glo + lo + slot
                _fill(
                    out, pos,
                    (w_obs[slot] - w_mu[slot]) / math.sqrt(w_var[slot]),
                    int(block.s_glob[slot]),
                    w_obs[slot], w_mu[slot], w_var[slot],
                )
                if verbose:
                    _print_ind(block.inds[slot], out, pos)
    return out


def reference_z_scores(
    beagle: BeagleData,
    ad: np.ndarray,
    popmap: PopulationMap,
    ind_start: int = 0,
    ind_end: Optional[int] = None,
    n_threshold: int = 0,
    single_read_threshold: bool = False,
    max_iter: int = 200,
    tol: float = 1e-4,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    verbose: bool = False,
    block_bytes: Optional[int] = None,
    error_rate: float = SEQ_ERROR_RATE,
    zloo_op=zloo_chunk,
    sites_op=sites_chunk,
    timer=None,
) -> ZScoreResult:
    """Reference mode: AF from a leave-one-out EM re-run of the individual's
    own population restricted to its kept sites (WGSassign.py:352-364).

    The reference's serial per-individual EM re-runs run as batched chunked
    EMs: loo-structured (``zloo_op``, the ``zloo_chunk`` kernel on a GPU)
    when the kept fraction is at least :data:`LOO_STRUCTURED_FILL`,
    gathered (``sites_op``, the ``sites_chunk`` kernel) otherwise.  The
    twins may be passed as ``zloo_op``/``sites_op`` to compare on a GPU.
    ``timer`` as in :func:`_run_blocks`.
    """
    if cohort is None:
        cohort = to_device(beagle, runtime)
    rt = cohort.runtime
    chunked = rt.chunked_em()  # on a GPU: build, load and probe, or raise
    reduce = rt.all_reduce_sum
    engines = set()
    dev = rt.device
    n = cohort.n_inds
    ind_end = n if ind_end is None else ind_end

    members_of = {}
    for i in range(ind_start, ind_end):
        members = popmap.members_of(popmap.pop_labels[i])
        members = members[members != i]
        if members.size == 0:
            raise ValueError(
                f"Individual {i} is the only member of its population; "
                "reference z-score needs a leave-one-out AF"
            )
        members_of[i] = members.astype(np.int32)
    # the member axis is not padded beyond the largest population: masked
    # members add nothing and the kernels take P at run time
    p_pad = max((m.size for m in members_of.values()), default=1)
    pop_members = {
        lab: popmap.members_of(lab).astype(np.int64)
        for lab in set(popmap.pop_labels[ind_start:ind_end])
    }

    def loo_structured_block(block: _ZBlock):
        # per population: the [n_p, M] member panel shared by its problems,
        # a full-site EM with kept-site masks only in the convergence
        # partials, then a [G, S] gather of the kept values
        slots_by_pop = {}
        for slot, i in enumerate(block.inds):
            slots_by_pop.setdefault(popmap.pop_labels[i], []).append(slot)
        parts, slot_order, iters = [], [], []
        for lab, slots in slots_by_pop.items():
            members = pop_members[lab]
            n_p = int(members.size)
            pos_of = {int(mm): idx for idx, mm in enumerate(members)}
            leave = np.asarray(
                [pos_of[block.inds[s]] for s in slots], np.int32
            )
            g0p, g1p = _member_panels(cohort.g0, cohort.g1,
                                      _put(members, dev))
            w_full = _scatter_site_weight(
                block.keep[slots], block.weight[slots], cohort.m_pad, dev
            )
            s_real_g = np.maximum(block.s_glob[slots], 1.0).astype(F32)
            if chunked:
                engines.add("zloo_chunk")
                f, it, _ = em_maf_loo_subset_fused(
                    g0p, g1p, leave, w_full, s_real_g, max_iter, tol,
                    fast_math=rt.fast_math, chunk_op=zloo_op, reduce=reduce,
                )
            else:
                engines.add("plain")
                f, it, _ = em_maf_loo_subset(
                    g0p, g1p, leave, w_full, s_real_g, max_iter, tol,
                    reduce=reduce,
                )
                it = it.cpu().numpy()
            # reference clamp with n = LOO member count n_p - 1
            parts.append(_gather_kept_af(f, block.keep[slots],
                                         1.0 / (2.0 * n_p)))
            slot_order.extend(slots)
            iters.append(it)
        inv_order = np.argsort(np.asarray(slot_order))
        af = torch.cat(parts, dim=0).index_select(0, _put(inv_order, dev))
        return af, np.concatenate(iters)[inv_order]

    def gathered_block(block: _ZBlock):
        b = len(block.inds)
        mem = np.zeros((b, p_pad), dtype=np.int32)
        mem_mask = np.zeros((b, p_pad), dtype=F32)
        for slot, i in enumerate(block.inds):
            m = members_of[i]
            mem[slot, : m.size] = m
            mem[slot, m.size :] = m[0]  # valid (masked) index
            mem_mask[slot, : m.size] = 1.0
        g0p, g1p = _gather_member_panels(cohort.g0, cohort.g1, block.keep,
                                         mem)
        s_real_g = np.maximum(block.s_glob, 1.0)
        if chunked:
            engines.add("sites_chunk")
            f, it, _ = em_maf_sites_batch_fused(
                g0p, g1p, mem_mask, block.weight, s_real_g, max_iter, tol,
                fast_math=rt.fast_math, chunk_op=sites_op, reduce=reduce,
            )
        else:
            engines.add("plain")
            f, it, _ = em_maf_sites_batch(
                g0p, g1p, _put(mem_mask, dev), _put(block.weight, dev),
                _put(s_real_g, dev, torch.float32), max_iter, tol,
                reduce=reduce,
            )
            it = it.cpu().numpy()
        return _clamp_loo_af(f, _put(mem_mask, dev)), it

    def loo_structured(fill: float) -> bool:
        # several ranks always take the loo-structured EM (the JAX
        # package's rule on several devices): a gathered problem's kept
        # sites lie in every rank's window
        return rt.world > 1 or fill >= LOO_STRUCTURED_FILL

    def af_block(block: _ZBlock, fill: float):
        if loo_structured(fill):
            return loo_structured_block(block)
        return gathered_block(block)

    def extra_bytes(s_pad: int, fill: float) -> int:
        # loo-structured shares per-population [n_p, M] panels, so each
        # problem adds a few site rows (ft/sw/af); the gathered form
        # materializes two [P, S] member panels per problem
        if loo_structured(fill):
            return 16 * max(s_pad, cohort.m_pad * rt.world)
        return 2 * p_pad * s_pad * 4

    out = _run_blocks(
        cohort, beagle, ad, ind_start, ind_end, af_block, extra_bytes,
        n_threshold, single_read_threshold, verbose, block_bytes,
        error_rate, timer,
    )
    out.structure = ("loo-structured" if loo_structured(out.fill)
                     else "gathered")
    out.engine = "+".join(sorted(engines))
    return out


def assignment_z_scores(
    beagle: BeagleData,
    ad: np.ndarray,
    assigned_labels,
    af: np.ndarray,
    pops,
    ind_start: int = 0,
    ind_end: Optional[int] = None,
    n_threshold: int = 0,
    single_read_threshold: bool = False,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    verbose: bool = False,
    block_bytes: Optional[int] = None,
    error_rate: float = SEQ_ERROR_RATE,
    timer=None,
    sums_op=zscore_sums_batch_compact,
) -> ZScoreResult:
    """Assignment mode: AF is the saved panel's column for the individual's
    *assigned* population, sliced at the kept sites (WGSassign.py:425-443).
    ``timer`` as in :func:`_run_blocks`.  ``sums_op`` is the z-sums
    function: :func:`zscore_sums_batch_compact`, or that with
    ``sum_dtype=torch.float64`` where a check needs the sums free of float32
    rounding."""
    if cohort is None:
        cohort = to_device(beagle, runtime)
    dev = cohort.runtime.device
    n = cohort.n_inds
    ind_end = n if ind_end is None else ind_end
    af = np.asarray(af, F32)
    pops = np.asarray(pops, dtype=str)
    assigned_labels = np.asarray(assigned_labels, dtype=str)

    col_of = {}
    for i in range(ind_start, ind_end):
        hits = np.flatnonzero(pops == assigned_labels[i])
        if hits.size == 0:
            raise ValueError(
                f"Assigned population {assigned_labels[i]!r} of individual {i} "
                "not found in the population-names file"
            )
        col_of[i] = int(hits[0])

    # a misaligned AF panel would otherwise gather pad values or row-shifted
    # AFs into silently wrong z-scores
    if af.shape[0] != cohort.m_real:
        raise ValueError(
            f"AF panel covers {af.shape[0]} sites, but the analysis covers "
            f"{cohort.m_real} — --pop_af_file must align row-for-row with "
            "the Beagle sites in use"
        )
    if af.shape[1] != len(pops):
        raise ValueError(
            f"AF panel has {af.shape[1]} populations, but the "
            f"--pop_names file lists {len(pops)}"
        )
    af_dev = _put(local_rows(af, cohort, PAD_AF), dev)  # once per run

    def af_block(block: _ZBlock, fill: float):
        cols = np.asarray([col_of[i] for i in block.inds], np.int64)
        return (_gather_af_block(af_dev, block.keep, cols),
                np.zeros(len(block.inds), np.int32))

    out = _run_blocks(
        cohort, beagle, ad, ind_start, ind_end, af_block,
        # keep-index upload + AF output + gather index temporaries
        lambda s, fill: 16 * s,
        n_threshold, single_read_threshold, verbose, block_bytes,
        error_rate, timer, sums_op,
    )
    out.structure = "assignment"
    return out


def _empty_result(n_sub: int) -> ZScoreResult:
    return ZScoreResult(
        z=np.empty(n_sub, dtype=F32),
        loci=np.empty(n_sub, dtype=np.int32),
        w_obs=np.empty(n_sub, dtype=F32),
        w_mu=np.empty(n_sub, dtype=F32),
        w_var=np.empty(n_sub, dtype=F32),
        em_iters=np.zeros(n_sub, dtype=np.int32),
    )


def _fill(out: ZScoreResult, pos: int, z, loci, w_obs, w_mu, w_var):
    out.z[pos] = z
    out.loci[pos] = loci
    out.w_obs[pos] = w_obs
    out.w_mu[pos] = w_mu
    out.w_var[pos] = w_var


def _print_ind(i: int, out: ZScoreResult, pos: int):
    print(f"Finished individual {i}")
    print(f"z_mu: {out.w_mu[pos]}")
    print(f"z_var: {out.w_var[pos]}")
    print(f"z_obs: {out.w_obs[pos]}")
    print(f"Loci used: {out.loci[pos]}")
    print(f"Z-score: {out.z[pos]}")
