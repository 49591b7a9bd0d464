"""Assignment z-scores (``--get_reference_z_score`` /
``--get_assignment_z_score``).

Counterpart of ``wgsassign_tpu/models/zscore.py``, same semantics
(reference WGSassign.py:346-384, 425-446).  Per individual i:

1. Group sites by i's allele-depth combo (Ar, Aa); per combo record the
   count and mean GL triple.
2. Filter combos: ``single_read`` keeps total-depth-1 combos; otherwise
   count > threshold and depth != 0; then keep only depths D whose combo
   count exceeds D (all D+1 splits observed).
3. Keep sites whose combo survived and whose GL at the combo mean's argmax
   entry is within 0.01 of that mean.
4. AF at kept sites: reference mode re-runs the LOO EM of i's population on
   i's kept sites; assignment mode takes the saved AF panel's column of i's
   *assigned* population.
5. Binomial read-probability tables with error rate e (``--zscore_error_rate``,
   0.01 in the reference); observed, expected and variance sums;
   Z = (W_obs - mu) / sqrt(var).

Everything runs on the device, from the GL planes of the
:class:`DeviceCohort` and the allele depths beside them
(:class:`DeviceDepths`).  Steps 1-3 (:func:`build_tables`) run for a block
of individuals at once: two passes over the cohort (``ops/ztables.py``, a
CUDA kernel each on a GPU) around batched ops on the ``[B, W * W]`` combo
tables, and one small fetch per block brings the kept-site counts and the
filter's error flags to the host.  The kept sites stay a device mask.
Reference mode runs its per-individual EMs in one of two structures, chosen
once per run by the kept fraction ``fill`` exactly as the JAX package
chooses on one device: loo-structured (``zloo_chunk`` kernel, full site
axis) when ``fill >= 0.5``, gathered (``sites_chunk`` kernel, kept sites
only) otherwise.  Under ``--no_pallas`` the plain ops of ``ops/emmaf.py`` run
in the same structure instead, and the tables' two passes run their plain
twins; ``ZScoreResult.engine`` says which ran.  The
three z sums are float64 (float32 under ``--f32_sums``, as the JAX package
sums them), one ``zsums`` kernel launch an AF group on a GPU
(``ops/zscore_ops.py``; its plain twin under ``--no_pallas``).

With several ranks each rank bins its own window of the site axis; the
per-combo sums and the per-depth kept counts are added over the ranks, so
every rank applies the same filters and reports the same loci.  The EM is
always loo-structured then, as in the JAX package on several devices; its
convergence partials and the three z sums are added over the ranks before
``z`` is formed.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import PopulationMap
from wgsassign_tpu_torch.models.common import (
    DeviceCohort,
    DeviceDepths,
    local_rows,
    to_device,
    upload_allele_depths,
)
from wgsassign_tpu_torch.models.loo import _member_panels
from wgsassign_tpu_torch.obs.profiling import count, span
from wgsassign_tpu_torch.ops.emmaf import em_maf_loo_subset, em_maf_sites_batch
from wgsassign_tpu_torch.ops.fused_em import (
    em_maf_loo_subset_fused,
    em_maf_sites_batch_fused,
)
from wgsassign_tpu_torch.ops.sites_chunk import sites_chunk
from wgsassign_tpu_torch.ops.zscore_ops import kept_slot_sums
from wgsassign_tpu_torch.ops.ztables import (
    PARTIAL_BYTES,
    combo_bins,
    site_filter,
)
from wgsassign_tpu_torch.parallel.runtime import (
    PAD_AF,
    Runtime,
    synchronize,
)

F32 = np.float32

SEQ_ERROR_RATE = 0.01       # hard-coded in the reference (WGSassign.py:350,430)
GL_MEAN_TOLERANCE = 0.01    # hard-coded in the reference (zscore.py:55)

# Device-memory budgets, sized for an 80 GB H100 (PERF.md).  Z_BLOCK_BYTES
# bounds one block of the z sums' plain twin (``--no_pallas``, the CPU): at
# ~256 bytes per kept-site slot and individual (inputs, the per-split lg/wt
# rows kept between the two passes, gather temporaries) it holds 32
# individuals at 1M kept-site slots.  The kernel sums an AF group in one
# launch and needs no temporaries.
Z_BLOCK_BYTES = 8 << 30
# One AF/EM group: the individuals whose kept-site AF panels (reference
# mode: whose LOO EMs) are produced by one af_block_fn call.  Its AF panel
# stays resident through all of the group's z-sums blocks.
AF_GROUP_BYTES = 4 << 30
AF_GROUP_MAX_INDS = 64

# Kept fraction at or above which reference mode takes the loo-structured
# EM (the JAX package's single-device rule, models/zscore.py:744).
LOO_STRUCTURED_FILL = 0.5

_ERRORS = {
    1: "Not enough allele-count combinations were kept! Too stringent "
       "filtering?",
    2: "No complete depth classes survived filtering (no depth has all of "
       "its allele-count splits observed)",
    3: "No loci were kept! Too stringent filtering?",
}


class FilteringError(ValueError):
    pass


@dataclass
class ComboTables:
    """The combo tables of individuals ``ind_start + j`` (row ``j``), on the
    device.  Kept combos take compact rows in ascending (Ar, Aa) order;
    rows past an individual's ``n_rows`` are padding: combo (0, 0), mean
    GL (1, 0, 0) and read probabilities 0, never referenced."""

    mask: torch.Tensor           # uint8 [n, m_pad]: 1 at the window's kept sites
    combos: torch.Tensor         # int32 [n, R, 2] (Ar, Aa) per row
    mean_gl: torch.Tensor        # float32 [n, R, 3] mean GL triple per row
    read_probs: torch.Tensor     # float32 [n, R, 3] P(reads | genotype)
    rows_by_depth: torch.Tensor  # int32 [n, C, C] row of split (d - x, x)
    n_rows: np.ndarray           # [n] kept combos
    s_local: np.ndarray          # [n] kept sites in this rank's window
    s_glob: np.ndarray           # [n] kept sites over the whole site axis


def _bucket(n: int, mult: int) -> int:
    """Round up to the next power of two, then to a multiple of ``mult``
    (few distinct padded sizes across runs)."""
    n = max(n, 1)
    size = 1 << (n - 1).bit_length()
    return -(-max(size, mult) // mult) * mult


@functools.lru_cache(maxsize=8)
def _read_prob_grid(width: int, e: float) -> np.ndarray:
    """``[width * width, 3]`` float32 read probabilities of every combo
    ``(Ar, Aa) = divmod(code, width)``, in the reference's own float64
    arithmetic (zscore.py: the binomial coefficient times the per-genotype
    read likelihoods), then rounded to float32."""
    out = np.zeros((width * width, 3), dtype=F32)
    for car in range(width):
        for caa in range(width):
            d = car + caa
            c = math.factorial(d) / (math.factorial(caa)
                                     * math.factorial(car))
            out[car * width + caa] = (
                c * ((1.0 - e) ** car) * (e**caa),
                c * (0.5**d),
                c * ((1.0 - e) ** caa) * (e**car),
            )
    return out


def _table_block(n: int, width: int) -> int:
    """Individuals a tables block takes: as many as leave the partial
    buffer room for 64 chunks of the site axis."""
    per_ind = 32 * width * width * 64
    return int(max(1, min(n, PARTIAL_BYTES // per_ind)))


def build_tables(cohort: DeviceCohort, depths: DeviceDepths, ind_start: int,
                 ind_end: int, n_threshold: int, single_read_threshold: bool,
                 error_rate: float = SEQ_ERROR_RATE) -> ComboTables:
    """Steps 1-3 and the read-probability and split tables of individuals
    ``[ind_start, ind_end)``, in blocks of consecutive individuals.  Raises
    :class:`FilteringError` for the first individual whose filters leave
    too little, with the reference's message."""
    rt = cohort.runtime
    dev = rt.device
    n = ind_end - ind_start
    width = int(depths.col_max[ind_start:ind_end].max()) + 1
    r, d = width * width, 2 * width - 1
    r_all, c_all = _bucket(r, 4), _bucket(d, 4)
    code = torch.arange(r, device=dev)
    ar, aa = code // width, code % width
    tot = ar + aa
    grid = torch.from_numpy(_read_prob_grid(width, float(error_rate))).to(dev)
    pairs = torch.stack([ar, aa], dim=1).to(torch.int32)
    depth_ids = torch.arange(d, device=dev)
    # one spare row or cell at the end of each table takes what is not kept
    mask = torch.zeros((n, cohort.m_pad), dtype=torch.uint8, device=dev)
    combos = torch.zeros((n, r_all + 1, 2), dtype=torch.int32, device=dev)
    mean_gl = torch.zeros((n, r_all + 1, 3), dtype=torch.float32, device=dev)
    mean_gl[:, :, 0] = 1.0
    read_probs = torch.zeros((n, r_all + 1, 3), dtype=torch.float32,
                             device=dev)
    rbd = torch.zeros((n, c_all * c_all + 1), dtype=torch.int32, device=dev)
    stats = []
    step = _table_block(n, width)
    for lo in range(0, n, step):
        b = min(step, n - lo)
        col0 = ind_start + lo
        part = combo_bins(depths.counts, cohort.g0, cohort.g1, col0, b,
                          cohort.n_local, width, kernel=rt.use_kernels)
        sums = rt.all_reduce_sum(part.sum(0)).to(dev)  # [b, R, 4]
        del part
        cnt = sums[..., 3]
        if single_read_threshold:
            keep = (cnt > 0) & (tot == 1)
        else:
            keep = (cnt > n_threshold) & (tot != 0)
        n_first = keep.sum(1)
        # keep only depths whose D + 1 splits all survived
        per_depth = torch.zeros((b, d), dtype=torch.long, device=dev)
        per_depth.scatter_add_(1, tot.expand(b, r), keep.long())
        keep &= (per_depth > depth_ids)[:, tot]
        n_rows = keep.sum(1)
        mean = sums[..., :3] / cnt.clamp(min=1.0)[..., None]
        amax = mean.argmax(dim=2)
        meanv = mean.gather(2, amax[..., None])[..., 0].contiguous()
        dcount = site_filter(depths.counts, cohort.g0, cohort.g1, col0, b,
                             cohort.n_local, width, keep.to(torch.uint8),
                             amax.to(torch.uint8), meanv, mask[lo:lo + b],
                             GL_MEAN_TOLERANCE, kernel=rt.use_kernels)
        local = dcount.sum(0, dtype=torch.long)  # [b, D] kept sites by depth
        glob = rt.all_reduce_sum(local).to(dev)
        present = glob > 0
        # compact rows in code order, and the split table of each depth
        # that some kept site has
        row = torch.where(keep, torch.cumsum(keep, 1) - 1, r_all)
        idx = row[..., None]
        combos[lo:lo + b].scatter_(1, idx.expand(b, r, 2),
                                   pairs.expand(b, r, 2))
        mean_gl[lo:lo + b].scatter_(1, idx.expand(b, r, 3),
                                    mean.to(torch.float32))
        read_probs[lo:lo + b].scatter_(1, idx.expand(b, r, 3),
                                       grid.expand(b, r, 3))
        cell = torch.where(keep & present[:, tot], tot * c_all + aa,
                           c_all * c_all)
        rbd[lo:lo + b].scatter_(1, cell, row.to(torch.int32))
        s_loc, s_glob = local.sum(1), glob.sum(1)
        err = torch.where(n_first < 2, 1, torch.where(
            n_rows == 0, 2, torch.where(s_glob == 0, 3, 0)))
        c_max = (present * (depth_ids + 1)).amax(1)
        block = torch.stack([err, s_loc, s_glob, n_rows, c_max]).cpu()
        block = block.numpy()  # the block's one fetch
        bad = np.flatnonzero(block[0])
        if bad.size:
            raise FilteringError(_ERRORS[int(block[0, bad[0]])])
        stats.append(block[1:])
    s_local, s_glob, n_rows, c_max = np.concatenate(stats, axis=1)
    r_pad, c_pad = _bucket(int(n_rows.max()), 4), _bucket(int(c_max.max()), 4)
    # the split and combo tables contiguous: a group's rows are operands
    # of the z-sums kernel
    return ComboTables(
        mask=mask, combos=combos[:, :r_pad],
        mean_gl=mean_gl[:, :r_pad].contiguous(),
        read_probs=read_probs[:, :r_pad].contiguous(),
        rows_by_depth=rbd[:, :-1].reshape(n, c_all, c_all)[:, :c_pad, :c_pad]
        .contiguous(),
        n_rows=n_rows, s_local=s_local, s_glob=s_glob)


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
    """One group of individuals' kept sites on the device, for the EM and
    the z sums: their rows of the tables' mask, and the kept-site indices
    of this rank's window compacted to ``s_pad`` slots."""

    inds: List[int]          # individual per slot
    mask: torch.Tensor       # uint8 [B, m_pad]
    keep: torch.Tensor       # int64 [B, S] kept-site indices (pad -> 0)
    weight: torch.Tensor     # float32 [B, S], 1.0 on the kept slots
    s_glob: np.ndarray       # float32 [B] kept-site counts over all windows


def _kept_slots(mask: torch.Tensor, s_pad: int):
    """``(keep [B, s_pad] int64, weight [B, s_pad] float32)`` from kept-site
    masks: each row's kept sites in ascending order, padded with index 0 at
    weight 0 (no fetch: the slot of a site is its rank among the row's)."""
    b, m = mask.shape
    kept = mask.bool()
    slot = torch.where(kept, torch.cumsum(mask, 1, dtype=torch.long) - 1,
                       s_pad)
    keep = torch.zeros((b, s_pad + 1), dtype=torch.long, device=mask.device)
    keep.scatter_(1, slot, torch.arange(m, device=mask.device).expand(b, m))
    weight = torch.zeros((b, s_pad + 1), dtype=torch.float32,
                         device=mask.device)
    weight.scatter_(1, slot, kept.to(torch.float32))
    # the kernels take the weights as a contiguous [B, s_pad] operand
    return keep[:, :s_pad], weight[:, :s_pad].contiguous()


def _gather_kept_af(f, keep, min_val):
    """Clamped AF at each problem's kept sites: ``[G, M] -> [G, S]``;
    ``min_val`` is rounded to float32 first, as the JAX package does."""
    mv = torch.tensor(min_val, dtype=torch.float32, device=f.device)
    return torch.clamp(torch.gather(f, 1, keep), mv, 1.0 - mv)


def _clamp_loo_af(f, mem_mask):
    """Reference clamp with n = LOO member count (WGSassign.py:358-364)."""
    counts = torch.sum(mem_mask, dim=1)
    min_val = (1.0 / (2.0 * (counts + 1.0)))[:, None]
    return torch.clamp(f, min_val, 1.0 - min_val)


def _as_depths(ad, cohort: DeviceCohort) -> DeviceDepths:
    if isinstance(ad, DeviceDepths):
        if ad.counts.device != cohort.runtime.device:
            raise ValueError(f"allele depths are on {ad.counts.device}, the "
                             f"cohort on {cohort.runtime.device}")
        return ad
    return upload_allele_depths(ad, cohort)


def _run_blocks(
    cohort, depths, ind_start, ind_end, af_block_fn, per_ind_bytes_extra,
    n_threshold, single_read_threshold, verbose, block_bytes=None,
    error_rate=SEQ_ERROR_RATE, timer=None, f64_sums=True,
):
    """Shared batched driver.  ``af_block_fn(block, fill)`` returns a
    device ``[B, S]`` AF panel for the block's kept sites and the ``[B]``
    EM iteration counts behind it.  With a ``timer``
    (:class:`wgsassign_tpu_torch.obs.profiling.RunTimer`) the tables, the AF
    groups and their z sums are timed as the phases ``zscore_tables``,
    ``zscore_af`` and ``zscore_sums``; they are also the spans
    ``wgsa.zscore.tables``, ``wgsa.zscore.em`` and ``wgsa.zscore.sums``.
    ``f64_sums`` sums the three z sums in float64 (else float32): one
    ``zsums`` launch an AF group on a GPU, the plain twin in blocks of
    individuals on the CPU and under ``--no_pallas``, and one fetch an AF
    group either way."""
    rt = cohort.runtime
    dev = rt.device

    @contextlib.contextmanager
    def phase(name, span_name):
        with (timer.phase(name) if timer is not None
              else contextlib.nullcontext()), span(span_name):
            yield

    inds = list(range(ind_start, ind_end))
    out = _empty_result(len(inds))
    if not inds:
        return out
    with phase("zscore_tables", "wgsa.zscore.tables"):
        tables = build_tables(cohort, depths, ind_start, ind_end,
                              n_threshold, single_read_threshold, error_rate)
    s_pad = _bucket(int(tables.s_local.max()), 1)
    s_size = _bucket(int(tables.s_glob.max()), 1)  # == s_pad with one rank
    per_ind = s_size * 256
    budget = Z_BLOCK_BYTES if block_bytes is None else block_bytes
    b = int(max(1, min(len(inds), budget // max(per_ind, 1))))

    # AF/EM group size, decoupled from the z-sums block size: a population's
    # problems share one batched EM drive for many z-sums blocks.  ``fill``
    # (kept fraction over the whole range) also fixes the reference-mode EM
    # structure for every block of the run.
    fill = float(tables.s_glob.sum()) / max(
        len(inds) * max(cohort.m_real, 1), 1)
    out.fill = fill
    per_ind_af = max(per_ind_bytes_extra(s_size, fill), 4 * s_size)
    b_af = int(max(b, min(
        len(inds), AF_GROUP_MAX_INDS, AF_GROUP_BYTES // per_ind_af
    )))
    sum_dtype = torch.float64 if f64_sums else torch.float32

    for glo in range(0, len(inds), b_af):
        g_inds = inds[glo: glo + b_af]
        g_n = len(g_inds)
        g_mask = tables.mask[glo: glo + g_n]
        keep, weight = _kept_slots(g_mask, s_pad)
        g_block = _ZBlock(inds=g_inds, mask=g_mask, keep=keep, weight=weight,
                          s_glob=tables.s_glob[glo: glo + g_n].astype(F32))
        with phase("zscore_af", "wgsa.zscore.em"):
            af_group, g_iters = af_block_fn(g_block, fill)
            synchronize(dev)
        out.em_iters[glo: glo + g_n] = g_iters
        s_loc = tables.s_local[glo: glo + g_n]
        with phase("zscore_sums", "wgsa.zscore.sums"):
            sums = kept_slot_sums(
                cohort.g0, cohort.g1, depths.counts, ind_start + glo, keep,
                af_group, s_loc, tables.rows_by_depth[glo: glo + g_n],
                tables.mean_gl[glo: glo + g_n],
                tables.read_probs[glo: glo + g_n], sum_dtype, block=b,
                kernel=rt.use_kernels)
            # float64 before the sum over the ranks, as on one rank
            # before ``z`` is formed
            w_obs, w_mu, w_var = rt.all_reduce_sum(
                sums.to(torch.float64)).cpu().numpy()
        for slot in range(g_n):
            pos = glo + slot
            _fill(
                out, pos,
                (w_obs[slot] - w_mu[slot]) / math.sqrt(w_var[slot]),
                int(tables.s_glob[pos]),
                w_obs[slot], w_mu[slot], w_var[slot],
            )
            if verbose:
                _print_ind(inds[pos], out, pos)
    return out


def reference_z_scores(
    beagle: BeagleData,
    ad,
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
    zloo_op=None,
    sites_op=sites_chunk,
    timer=None,
    f64_sums: bool = True,
) -> ZScoreResult:
    """Reference mode: AF from a leave-one-out EM re-run of the individual's
    own population restricted to its kept sites (WGSassign.py:352-364).

    ``ad`` is the cohort's :class:`DeviceDepths`, or a host ``[M, 2N]``
    array, uploaded once (:func:`upload_allele_depths`).  The reference's
    serial per-individual EM re-runs run as batched EMs: loo-structured
    (``zloo_op`` None: the ``zloo_chunk`` kernel on a GPU) when
    the kept fraction is at least :data:`LOO_STRUCTURED_FILL`, gathered
    (``sites_op``, the ``sites_chunk`` kernel) otherwise.  The twins may be
    passed as ``zloo_op``/``sites_op`` to compare on a GPU.  ``timer`` and
    ``f64_sums`` as in :func:`_run_blocks`.

    Under a recording profiler the gathered form's ``[B, p_pad, s_pad]``
    member-panel gathers of each AF group are the span
    ``wgsa.zscore.gather`` (inside ``wgsa.zscore.em``), and the counters
    ``zscore.gather_useful`` and ``zscore.gather_launched`` add the group's
    real member x kept-site slots and all its panel slots.
    """
    if cohort is None:
        cohort = to_device(beagle, runtime)
    depths = _as_depths(ad, cohort)
    rt = cohort.runtime
    rt.load_kernels()  # on a GPU: build, load and probe, or raise
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
            sel = torch.tensor(slots, device=dev)
            g0p, g1p = _member_panels(cohort.g0, cohort.g1,
                                      torch.from_numpy(members).to(dev))
            w_full = block.mask.index_select(0, sel).to(torch.float32)
            s_real_g = np.maximum(block.s_glob[slots], 1.0).astype(F32)
            if rt.use_kernels:
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
            parts.append(_gather_kept_af(f, block.keep.index_select(0, sel),
                                         1.0 / (2.0 * n_p)))
            slot_order.extend(slots)
            iters.append(it)
        inv_order = np.argsort(np.asarray(slot_order))
        af = torch.cat(parts, dim=0)
        if len(parts) > 1:
            af = af.index_select(0, torch.from_numpy(inv_order).to(dev))
        return af, np.concatenate(iters)[inv_order]

    def gathered_block(block: _ZBlock):
        b = len(block.inds)
        mem = np.zeros((b, p_pad), dtype=np.int64)
        mem_mask = np.zeros((b, p_pad), dtype=F32)
        for slot, i in enumerate(block.inds):
            m = members_of[i]
            mem[slot, : m.size] = m
            mem[slot, m.size:] = m[0]  # valid (masked) index
            mem_mask[slot, : m.size] = 1.0
        k = block.keep[:, None, :]
        mm = torch.from_numpy(mem).to(dev)[:, :, None]
        with span("wgsa.zscore.gather"):
            g0p, g1p = cohort.g0[k, mm], cohort.g1[k, mm]
        # panel slots that hold a real member at a kept site, of all the
        # [B, p_pad, s_pad] slots gathered
        count("zscore.gather_useful", sum(
            members_of[i].size * int(s)
            for i, s in zip(block.inds, block.s_glob)))
        count("zscore.gather_launched", g0p.numel())
        s_real_g = np.maximum(block.s_glob, 1.0)
        mask_d = torch.from_numpy(mem_mask).to(dev)
        if rt.use_kernels:
            engines.add("sites_chunk")
            f, it, _ = em_maf_sites_batch_fused(
                g0p, g1p, mem_mask, block.weight, s_real_g, max_iter, tol,
                fast_math=rt.fast_math, chunk_op=sites_op, reduce=reduce,
            )
        else:
            engines.add("plain")
            f, it, _ = em_maf_sites_batch(
                g0p, g1p, mask_d, block.weight,
                torch.from_numpy(s_real_g.astype(F32)).to(dev), max_iter,
                tol, reduce=reduce,
            )
            it = it.cpu().numpy()
        return _clamp_loo_af(f, mask_d), it

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
        cohort, depths, ind_start, ind_end, af_block, extra_bytes,
        n_threshold, single_read_threshold, verbose, block_bytes,
        error_rate, timer, f64_sums,
    )
    out.structure = ("loo-structured" if loo_structured(out.fill)
                     else "gathered")
    out.engine = "+".join(sorted(engines))
    return out


def assignment_z_scores(
    beagle: BeagleData,
    ad,
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
    f64_sums: bool = True,
) -> ZScoreResult:
    """Assignment mode: AF is the saved panel's column for the individual's
    *assigned* population, sliced at the kept sites (WGSassign.py:425-443).
    ``ad``, ``timer`` and ``f64_sums`` as in :func:`reference_z_scores`."""
    if cohort is None:
        cohort = to_device(beagle, runtime)
    depths = _as_depths(ad, cohort)
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
    af_dev = torch.from_numpy(local_rows(af, cohort, PAD_AF)).to(dev)
    cols_all = torch.from_numpy(np.asarray(
        [col_of[i] for i in range(ind_start, ind_end)], np.int64)).to(dev)

    def af_block(block: _ZBlock, fill: float):
        lo = block.inds[0] - ind_start
        cols = cols_all[lo: lo + len(block.inds)]
        return (af_dev[block.keep, cols[:, None]],
                np.zeros(len(block.inds), np.int32))

    out = _run_blocks(
        cohort, depths, ind_start, ind_end, af_block,
        # AF output + gather index temporaries
        lambda s, fill: 16 * s,
        n_threshold, single_read_threshold, verbose, block_bytes,
        error_rate, timer, f64_sums,
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
