"""Leave-one-out cross-validated assignment (``--loo``).

Counterpart of ``wgsassign_tpu/models/loo.py``, with the same semantics
(reference glassy.loo, glassy.py:47-112): for each individual i, its own
population's AF is re-estimated with i left out, clamped, written into the
shared AF matrix **in place**, and i's log-likelihood to all K populations
is evaluated.  Because of the in-place write, the AF column used for a
foreign population j is the LOO AF of the most recent member of j with
index <= i (the full-data AF when none precedes) -- an order-dependent quirk
reproduced exactly, batched:

  * each population's n_p LOO EMs run as one batched chunked EM
    (:func:`em_maf_loo_group_fused`, the ``loo_chunk`` kernel on a GPU);
  * the quirky AF selection is a static ``[N, K]`` row-index table, and
    column j of it only references population j's LOO rows or the full-data
    column j, so LL column j is evaluated right after population j's EM
    against an ``[n_p + 1, M]`` mini-bank (the ``loglik`` kernel on a GPU);
    no ``[N + K, M]`` bank is built.

Everything stays on the device: member panels are gathers of the cohort,
and the full-data AF panel is handed over from the reference-AF step.

Under ``--no_pallas`` every population runs the plain
:func:`wgsassign_tpu_torch.ops.emmaf.em_maf_loo_group` on the same device
instead, and the likelihood pass its plain blocked form;
``LooResult.engines`` says which EM ran.  Nothing else leaves the
chunked EM: the ``loo_chunk`` kernel takes a population of any size (one
whose member tile does not fit in shared memory is read from global
memory), and a kernel that fails to build, load or launch raises.

With several ranks each rank runs the EMs and the per-site likelihoods on its
window of the site axis; the convergence partials and the float64
likelihood sums are summed over the ranks, so every rank returns the same
result.

``compat_af_mutation=False`` (``--loo_clean_af``) gives the statistically
clean variant: foreign-population likelihoods use the full-data AF.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import PopulationMap
from wgsassign_tpu_torch.obs.checkpoint import save_npz_atomic
from wgsassign_tpu_torch.models.common import (
    DeviceCohort,
    gather_real_sites,
    local_rows,
    to_device,
)
from wgsassign_tpu_torch.obs.checkpoint import make_checkpoint
from wgsassign_tpu_torch.obs.profiling import count, span
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS, em_maf_loo_group
from wgsassign_tpu_torch.ops.fused_em import em_maf_loo_group_fused
from wgsassign_tpu_torch.ops.loglik import (
    assign_loglik_selected_f64,
    check_loglik_inputs,
    loglik_partition_sums,
)
from wgsassign_tpu_torch.parallel.runtime import PAD_AF, Runtime


@dataclass
class LooResult:
    ll: np.ndarray         # float32 [N, K]
    parts: np.ndarray      # float32 [N * num_partitions, K] (partition sums)
    iters: np.ndarray      # int32 [N] per-individual LOO EM convergence iteration
    converged: np.ndarray  # bool [N]
    # per population (order of ``popmap.pops``), what ran its LOO EM:
    # "loo_chunk" (the chunked EM), "plain" (the plain op, under
    # --no_pallas), or "restart file" (a finished population loaded from its
    # --em_checkpoint file)
    engines: tuple = ()


def loo_af_column_index(popmap: PopulationMap, compat_af_mutation: bool) -> np.ndarray:
    """Abstract AF row selection ``[loo_0..loo_{N-1}, full_0..full_{K-1}]``
    used for pair (individual i, population j).  Column j only ever selects
    population j's LOO rows or the full-data sentinel ``n + j`` -- the
    property ``leave_one_out`` exploits to evaluate each column against a
    per-population mini-bank (``searchsorted`` remaps the values)."""
    n, k = popmap.n_inds, popmap.n_pops
    col_idx = np.empty((n, k), dtype=np.int32)
    all_inds = np.arange(n)
    for j in range(k):
        members = popmap.members_of(popmap.pops[j])
        if compat_af_mutation:
            # last member of pop j with index <= i (for i in pop j this is i
            # itself); fall back to the full-data column when none precedes.
            pos = np.searchsorted(members, all_inds, side="right") - 1
            col = np.where(pos >= 0, members[np.clip(pos, 0, None)], n + j)
        else:
            # clean mode: own pop -> own LOO column; foreign -> full-data AF.
            col = np.full(n, n + j, dtype=np.int64)
            col[members] = members
        col_idx[:, j] = col
    return col_idx


def leave_one_out(
    beagle: BeagleData,
    af_full: np.ndarray,
    popmap: PopulationMap,
    max_iter: int = 200,
    tol: float = 1e-4,
    downsampled: Optional[BeagleData] = None,
    num_partitions: int = 1,
    runtime: Optional[Runtime] = None,
    cohort: Optional[DeviceCohort] = None,
    downsampled_cohort: Optional[DeviceCohort] = None,
    compat_af_mutation: bool = True,
    verbose: bool = False,
    f64_sums: bool = True,
    checkpoint_path: Optional[str] = None,
    af_t_dev=None,
    chunk_op=None,
) -> LooResult:
    """``downsampled_cohort`` is a prebuilt likelihood-pass cohort (the
    streamed form of ``downsampled``).  ``chunk_op`` is None (the
    ``loo_chunk`` kernel on a GPU) or a LOO chunk function (see
    :func:`wgsassign_tpu_torch.ops.fused_em.em_maf_loo_group_fused`).
    Under the runtime's ``debug_checks`` the likelihood inputs are
    sanitised first (:func:`check_loglik_inputs`)."""
    if cohort is None:
        cohort = to_device(beagle, runtime, site_multiple=num_partitions)
    rt = cohort.runtime
    rt.load_kernels()  # on a GPU: build, load and probe, or raise
    n = cohort.n_inds
    m_pad = cohort.m_pad
    m_real = cohort.m_real
    device = rt.device

    sizes = popmap.pop_sizes
    if np.any(sizes < 2):
        bad = popmap.pops[sizes < 2]
        raise ValueError(
            f"Leave-one-out requires >= 2 individuals per population; too small: {bad}"
        )

    # --- source cohort for the likelihood pass (optionally downsampled) ----
    if downsampled_cohort is not None:  # prebuilt (streamed ingest)
        src = downsampled_cohort
    elif downsampled is not None:
        src = to_device(downsampled, rt, site_multiple=num_partitions)
    else:
        src = cohort
    if src is not cohort and (
        src.m_pad != cohort.m_pad or src.m_real != cohort.m_real
    ):
        raise ValueError(
            "Downsampled Beagle must cover the same sites as the reference "
            "after intersection"
        )

    k = popmap.n_pops
    if af_t_dev is not None and tuple(af_t_dev.shape) == (k, m_pad):
        # the clamped panel from estimate_reference_af, still on the device
        # (only padded-site values differ from the host rebuild, and those
        # are weighted to zero downstream)
        af_t = af_t_dev
    else:
        af_t_h = local_rows(np.asarray(af_full, np.float32), cohort, PAD_AF)
        af_t = torch.from_numpy(
            np.ascontiguousarray(af_t_h.T)).to(device)  # the only (small) H2D
    if rt.debug_checks:
        check_loglik_inputs(cohort.g0, cohort.g1, af_t.t(),
                            cohort.site_weight, reduce=rt.all_reduce_sum)
    col_idx_global = loo_af_column_index(popmap, compat_af_mutation)
    iters = np.empty(n, dtype=np.int32)
    converged = np.empty(n, dtype=bool)
    p_count = max(num_partitions, 1)
    ll = np.empty((n, k), dtype=np.float64)
    parts_nk = np.empty((n, p_count, k), dtype=np.float64)
    engines = []
    reduce = rt.all_reduce_sum
    for j, pop in enumerate(popmap.pops):
        with span("wgsa.loo.population"):
            members = popmap.members_of(pop)
            members_d = torch.from_numpy(members).to(device)
            done_path = (f"{checkpoint_path}.pop{j}.done.npz"
                         if checkpoint_path else None)
            # rank 0's view of the file decides, so the ranks stay in step
            if done_path and rt.broadcast_object(os.path.exists(done_path)):
                # per-population restart point: this population's LOO EM
                # already finished in an interrupted earlier run
                with np.load(done_path) as z:
                    f_h = np.full((len(members), m_pad), PAD_AF, np.float32)
                    f_h[:, : cohort.n_local] = z["f"][:, cohort.lo : cohort.hi]
                    it_p, conv_p = z["iters"], z["converged"]
                f_p = torch.from_numpy(f_h).to(device)
                engine = "restart file"
            else:
                f_p, it_p, conv_p, engine = _loo_group_em(
                    rt, cohort, members_d, m_real, max_iter, tol,
                    chunk_ckpt_path=(f"{checkpoint_path}.pop{j}.npz"
                                     if checkpoint_path else None),
                    chunk_op=chunk_op,
                )
                if done_path:
                    _save_pop_done(done_path, cohort, f_p, it_p, conv_p)
            engines.append(engine)
            n_loo = sizes[j] - 1
            min_val = np.float32(1.0 / (2.0 * (n_loo + 1.0)))
            with span("wgsa.loo.bank"):
                # mini-bank for LL column j: this population's clamped LOO
                # rows plus the full-data column (row n_p) for individuals
                # no j-member precedes
                mini_bank = _mini_bank(f_p, af_t, j, min_val)
                # map the global AF row selection to mini-bank rows: member
                # index -> its position; the full-data sentinel (n + j)
                # sorts past every member and lands on row n_p
                col_j = torch.from_numpy(np.searchsorted(
                    members, col_idx_global[:, j]
                ).astype(np.int32).reshape(n, 1)).to(device)
            with span("wgsa.loglik.selected"):
                ll[:, j], parts_nk[:, :, j] = _column_loglik(
                    src, mini_bank, col_j, num_partitions, f64_sums, reduce,
                    kernel=rt.use_kernels)
            iters[members] = it_p
            converged[members] = conv_p
            if verbose:
                print(f"LOO EM for population {pop}: {len(members)} "
                      f"problems, iterations {iters[members].min()}.."
                      f"{iters[members].max()} (engine: {engine})")
    if checkpoint_path and rt.is_primary():
        # LOO finished: drop the per-population restart files
        for j in range(k):
            for p in (f"{checkpoint_path}.pop{j}.done.npz",
                      f"{checkpoint_path}.pop{j}.npz"):
                if os.path.exists(p):
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass  # another process on a shared filesystem won

    return LooResult(
        ll=ll.astype(np.float32),
        parts=parts_nk.astype(np.float32).reshape(n * p_count, k),
        iters=iters,
        converged=converged,
        engines=tuple(engines),
    )


def _mini_bank(f_p, af_t, j, min_val):
    """``[n_p + 1, M]`` likelihood bank for one population: its clamped LOO
    AF rows followed by the full-data AF row ``j``."""
    return torch.cat(
        [torch.clamp(f_p, float(min_val), float(1.0 - min_val)),
         af_t[j: j + 1]], dim=0
    )


def _column_loglik(src, mini_bank, col_j, num_partitions, f64_sums,
                   reduce, kernel=True):
    """One population's LL column against its mini-bank, fetched to the
    host: ``(ll [N], parts [N, P])`` (P = 1 without partitions).
    ``kernel``: the ``loglik`` kernel on a GPU (False: the plain form).
    Under ``--f32_sums`` the partitions are added on the device."""
    args = (src.g0, src.g1, mini_bank, col_j, src.site_weight)
    count("host_syncs")
    if num_partitions <= 1 and f64_sums:
        ll_j = assign_loglik_selected_f64(*args, reduce, kernel)[:, 0]
        return ll_j, ll_j[:, None]
    parts = loglik_partition_sums(
        *args, max(num_partitions, 1),
        torch.float64 if f64_sums else torch.float32, reduce,
        kernel)[:, 0]  # [N, P]
    if f64_sums:
        parts = parts.cpu().numpy()
        return parts.sum(axis=1), parts
    return parts.sum(dim=1).cpu().numpy(), parts.cpu().numpy()


def _loo_group_em(rt, cohort, members_d, m_real, max_iter, tol,
                  chunk_ckpt_path=None, chunk_op=None):
    """One population's batched LOO EM.  Returns ``(f [n_p, M] on the
    device, iters, converged, engine)``: the chunked EM (the ``loo_chunk``
    kernel on a GPU), or under ``--no_pallas`` the plain
    :func:`em_maf_loo_group` on the same device."""
    with span("wgsa.loo.gather"):
        g0p, g1p = _member_panels(cohort.g0, cohort.g1, members_d)
    reduce = rt.all_reduce_sum
    with span("wgsa.loo.em"):
        if not rt.use_kernels:
            f, iters, conv = em_maf_loo_group(
                g0p, g1p, cohort.site_weight, m_real, max_iter, tol,
                reduce=reduce)
            return f, iters.cpu().numpy(), conv.cpu().numpy(), "plain"
        f, iters, conv = em_maf_loo_group_fused(
            g0p, g1p, m_real, max_iter, tol,
            checkpoint=make_checkpoint(chunk_ckpt_path, cohort, _EM_EPS),
            fast_math=rt.fast_math, chunk_op=chunk_op, reduce=reduce,
            n_local=cohort.n_local,
        )
    return f, iters, conv, "loo_chunk"


def _save_pop_done(path, cohort, f_p, it_p, conv_p):
    """Atomically record one population's finished LOO EM (real sites only)
    so an interrupted run resumes at population granularity.  With several
    ranks the rows are gathered and rank 0 writes."""
    f_h = gather_real_sites(cohort, f_p, axis=1)
    if f_h is None:
        return  # one writer per shared filesystem
    save_npz_atomic(
        path,
        f=np.asarray(f_h, np.float32),
        iters=np.asarray(it_p, np.int32),
        converged=np.asarray(conv_p, bool),
    )


def _member_panels(g0, g1, members):
    """Transposed device-side gather of one population's member columns:
    ``[M, N] -> [n_p, M]`` (site-minor).  Padded cohort rows already hold the
    (PAD_G0, PAD_G1) GL pattern the LOO EM pins to its fixed point."""
    return (g0.index_select(1, members).t().contiguous(),
            g1.index_select(1, members).t().contiguous())
