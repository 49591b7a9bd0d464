"""Chunked fused EMs (counterparts of ``em_maf_pops_fused``,
``em_maf_loo_group_fused``, ``em_maf_loo_subset_fused`` and
``em_maf_sites_batch_fused`` in ``wgsassign_tpu/ops/pallas_emmaf.py``).

Each chunk runs T EM iterations in one kernel launch (:func:`em_chunk`,
:func:`loo_chunk`, :func:`zloo_chunk`, :func:`sites_chunk`), which also
returns the per-iteration squared-update
sums ``sq[T, P]``.  The host rebuilds each problem's exact RMSE sequence
from ``sq``; when a problem converges inside a chunk, the chunk is replayed
from its snapshot with exact per-problem limits, so every problem stops at
the iteration an independent serial run would (``_drive_chunks``, copied
from the JAX package).  ``sq`` reaches the host once per chunk; the AF
panels stay on the device.

Padded sites start at ``_EM_EPS``, the fixed point of the (1, 0) padding GL
pattern, so they add exactly 0 to every ``sq``.

With several ranks each rank runs the chunks on its window of the site axis;
``reduce`` (``Runtime.all_reduce_sum``) sums ``sq`` over the ranks before
the host reads it, so every rank derives the same RMSEs, limits and replay
decision (counterpart of the ``psum`` in the JAX package's
``_sharded_*_chunk_fn``).

Under a recording profiler each chunk is the span ``wgsa.em.chunk``, with
``wgsa.em.sync`` (the ``sq`` fetch) and ``wgsa.em.replay`` inside it, and
adds to the counters ``<kernel>.launches``, ``.replays``,
``.launched_iters``, ``.useful_iters`` and ``host_syncs``
(``wgsassign_tpu_torch/obs/profiling.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wgsassign_tpu_torch.obs.profiling import count, span
from wgsassign_tpu_torch.ops.em_chunk import em_chunk
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS
from wgsassign_tpu_torch.ops.loo_chunk import loo_chunk
from wgsassign_tpu_torch.ops.sites_chunk import sites_chunk
from wgsassign_tpu_torch.ops.zloo_chunk import zloo_chunk

_F32 = torch.float32


def _device_init_ft(shape, m_real, device):
    """``0.25`` on real sites (< ``m_real`` along the last axis),
    ``_EM_EPS`` on padded sites, built on the device."""
    row = torch.where(torch.arange(shape[-1], device=device) < m_real,
                      0.25, _EM_EPS).to(_F32)
    return row.expand(shape).contiguous()


def _device_init_ft_from_weight(sw, shape):
    """As :func:`_device_init_ft` but padding is wherever the site weight
    is 0 (the reference-AF contract allows interior zero-weight sites)."""
    row = torch.where(sw > 0, 0.25, _EM_EPS).to(_F32)
    return row.expand(shape).contiguous()


def _jax_file_layout(f: np.ndarray, rows: int, m_real: int) -> np.ndarray:
    """A ``[P, M]`` panel in the checkpoint layout of the JAX package's fused EMs:
    ``rows`` problem rows and the site axis padded to a multiple of 128.
    Padded entries hold what the JAX package keeps there: its initial value,
    0.25 on real sites and ``_EM_EPS`` beyond ``m_real``."""
    cols = -(-f.shape[1] // 128) * 128
    pad_row = np.where(np.arange(cols) < m_real, 0.25, _EM_EPS)
    out = np.repeat(pad_row.astype(np.float32)[None, :], rows, axis=0)
    out[: f.shape[0], : f.shape[1]] = f
    return out


def _fit_panel(arr: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A checkpoint panel cut to ``[rows, cols]``: a JAX-written file
    carries padded problem rows and sites, which are cropped; a panel with
    fewer site columns than ``cols`` (written by a run with another padding)
    is filled up with ``_EM_EPS``, the value padded sites hold."""
    out = np.full((rows, cols), _EM_EPS, dtype=np.float32)
    src = arr[:rows, :cols]
    out[:, : src.shape[1]] = src
    return out


def _use_jax_layout(checkpoint, rows: int, m_real: int):
    if checkpoint is not None:
        checkpoint.file_layout = functools.partial(
            _jax_file_layout, rows=rows, m_real=m_real)


def em_maf_pops_fused(
    g0,
    g1,
    membership: np.ndarray,
    site_weight,
    m_real: int,
    max_iter: int,
    tol: float,
    chunk: int = 16,
    checkpoint=None,
    fast_math: bool = True,
    return_device_panel: bool = False,
    chunk_op=em_chunk,
    reduce=None,
):
    """All-K-population MAF EM in chunks of ``chunk`` fused iterations.

    Same contract as the plain :func:`wgsassign_tpu_torch.ops.emmaf.
    em_maf_pops`: returns ``(f [M, K] numpy, iters [K] int32, converged [K]
    bool)``; with ``return_device_panel=True`` ``f`` is the unclamped
    ``[K, M]`` panel on the device instead.  ``checkpoint`` (an
    :class:`wgsassign_tpu_torch.obs.checkpoint.EMCheckpoint`) enables
    periodic save and resume of the chunk state; ``fast_math`` picks the
    EM weight's op order (``Runtime.fast_math``).  ``chunk_op`` is the chunk
    function: :func:`em_chunk` (kernel on a GPU, twin on the CPU), or its
    twin where a check on the GPU compares the two.  ``reduce`` sums a
    tensor over the ranks (see the module docstring); ``m_real`` is then the
    global site count.
    """
    membership = np.asarray(membership, np.float32)
    n, k = membership.shape
    m = g0.shape[0]
    device = g0.device
    counts = membership.sum(axis=0)
    inv_counts = torch.from_numpy((1.0 / counts).astype(np.float32)).to(device)
    pop_index = torch.from_numpy(
        np.argmax(membership, axis=1).astype(np.int32)).to(device)

    def put_ft(arr):
        return torch.from_numpy(_fit_panel(arr, k, m)).to(device)

    def run_chunk(ft_in, limits_vec, T):
        limits = torch.from_numpy(limits_vec).to(device)
        return chunk_op(g0, g1, ft_in, pop_index, inv_counts, limits, T,
                        fast_math)

    ft = _device_init_ft_from_weight(site_weight, (k, m))
    _use_jax_layout(checkpoint, k, m_real)
    ft, iters, active = _drive_chunks(
        run_chunk, put_ft, ft, k, max_iter, tol, m_real, chunk, checkpoint,
        reduce, name="em_chunk",
    )
    if return_device_panel:
        return ft, iters, ~active
    f = np.ascontiguousarray(ft.t().cpu().numpy())
    return f, iters, ~active


def _drive_chunks(run_chunk, put_ft, ft, n_problems, max_iter, tol, m_real,
                  chunk, checkpoint, reduce=None, *, name):
    """Shared chunk/replay orchestration for the fused EMs.

    ``run_chunk(ft, limits [P] float32 numpy, T)`` runs T fused iterations
    with per-problem update limits and returns ``(ft_new, sq [T, P])`` with
    ``ft_new`` a fresh tensor: ``ft`` is kept as the replay snapshot, which
    JAX's immutable arrays made safe by construction.  The host rebuilds
    each problem's exact RMSE sequence from ``sq``; when a problem converges
    mid-chunk, the chunk is replayed from its snapshot with exact limits so
    the returned state matches a serial run that stopped each problem at its
    own convergence iteration.

    ``m_real`` may be a scalar (shared RMSE denominator) or a ``[P]``
    vector (per-problem site counts).  With ``reduce`` the chunk's ``sq`` is
    summed over the ranks before the host reads it: every decision below is
    taken from that sum alone, so the ranks stay in step.

    ``name`` is the chunk kernel's name, the prefix of the counters of
    launches, replays, launched and useful problem-iterations
    (:func:`wgsassign_tpu_torch.obs.profiling.count`); ``host_syncs``
    counts the ``sq`` fetches.

    Returns ``(ft, iters [P] int32, active [P] bool)``.
    """
    launches, replays, launched, useful = (
        name + s for s in (".launches", ".replays", ".launched_iters",
                           ".useful_iters"))
    m_real_vec = np.broadcast_to(
        np.asarray(m_real, np.float64), (n_problems,)
    )
    iters = np.full(n_problems, max_iter, dtype=np.int32)
    active = np.ones(n_problems, dtype=bool)
    it = 0
    if checkpoint is not None:
        state = checkpoint.load()
        if state is not None:
            ft_h2, iters, active, it = state
            ft = put_ft(np.asarray(ft_h2, np.float32))
            iters = np.asarray(iters, np.int32)
            active = np.asarray(active, bool)
    while it < max_iter and active.any():
        with span("wgsa.em.chunk"):
            T = min(chunk, max_iter - it)
            limits_vec = np.where(active, T, 0).astype(np.float32)
            ft_snapshot = ft
            ft, sq = run_chunk(ft, limits_vec, T)
            count(launches)
            count(launched, limits_vec.sum())
            if reduce is not None:
                sq = reduce(sq)
            # the one device->host sync of the chunk
            with span("wgsa.em.sync"):
                sq_h = sq.cpu().numpy()
            count("host_syncs")
            rmse = np.sqrt(np.maximum(sq_h, 0.0) / m_real_vec[None, :])
            # first iteration (within chunk) at which each active problem
            # converged
            crossed = rmse < tol  # [T, P]
            exact_limits = limits_vec.copy()
            replay = False
            for kk in range(n_problems):
                if not active[kk]:
                    continue
                hits = np.flatnonzero(crossed[:T, kk])
                if hits.size:
                    # updates taken when it converged
                    t_star = int(hits[0]) + 1
                    iters[kk] = it + t_star
                    active[kk] = False
                    if t_star < T:
                        exact_limits[kk] = t_star
                        replay = True
            if replay:
                with span("wgsa.em.replay"):
                    ft, _ = run_chunk(ft_snapshot, exact_limits, T)
                count(replays)
                count(launched, exact_limits.sum())
            it += T
            if checkpoint is not None:
                checkpoint.maybe_save(ft, iters, active, it)
    if checkpoint is not None:
        checkpoint.clear()
    count(useful, iters.sum())
    return ft, iters, active


def em_maf_loo_group_fused(
    g0p,
    g1p,
    m_real: int,
    max_iter: int,
    tol: float,
    chunk: int = 8,
    checkpoint=None,
    fast_math: bool = True,
    chunk_op=loo_chunk,
    reduce=None,
    n_local=None,
):
    """Batched leave-one-out EM for one population in chunks of ``chunk``
    fused iterations.

    Same contract as the plain :func:`wgsassign_tpu_torch.ops.emmaf.
    em_maf_loo_group`: ``g0p``/``g1p`` are the members' ``[n_p, M]`` GL
    panels (sites >= ``m_real`` hold the (1, 0) padding pattern); returns
    ``(f [n_p, M] on the device, iters [n_p] int32, converged [n_p] bool)``.
    ``fast_math``, ``chunk_op`` and ``reduce`` as in
    :func:`em_maf_pops_fused`; with ``reduce``, ``m_real`` is the global
    site count and ``n_local`` the real sites of this rank's window.
    """
    n_p, m = g0p.shape
    device = g0p.device

    def put_ft(arr):
        return torch.from_numpy(_fit_panel(arr, n_p, m)).to(device)

    def run_chunk(ft_in, limits_vec, T):
        limits = torch.from_numpy(limits_vec).to(device)
        return chunk_op(g0p, g1p, ft_in, limits, n_p, T, fast_math)

    ft = _device_init_ft((n_p, m), m_real if n_local is None else n_local,
                         device)
    _use_jax_layout(checkpoint, -(-n_p // 8) * 8, m_real)
    ft, iters, active = _drive_chunks(
        run_chunk, put_ft, ft, n_p, max_iter, tol, m_real, chunk, checkpoint,
        reduce, name="loo_chunk",
    )
    return ft, iters, ~active


def em_maf_loo_subset_fused(
    g0p,
    g1p,
    leave_out,
    site_weight,
    m_real,
    max_iter: int,
    tol: float,
    chunk: int = 8,
    fast_math: bool = True,
    chunk_op=zloo_chunk,
    reduce=None,
):
    """B leave-one-out EMs of one population over the full site axis, in
    chunks of ``chunk`` fused iterations (the z-score reference mode's
    loo-structured form).

    Same contract as the plain :func:`wgsassign_tpu_torch.ops.emmaf.
    em_maf_loo_subset`: ``g0p``/``g1p`` are the population's ``[n_p, M]``
    member panels, ``leave_out`` the ``[B]`` member rows left out,
    ``site_weight`` the ``[B, M]`` kept-site masks on the device and
    ``m_real`` the ``[B]`` kept-site counts; returns ``(f [B, M] on the
    device, iters [B] int32, converged [B] bool)``.  ``fast_math``,
    ``chunk_op`` and ``reduce`` as in :func:`em_maf_pops_fused`.
    """
    n_p, m = g0p.shape
    device = g0p.device
    leave = torch.as_tensor(np.asarray(leave_out, np.int32), device=device)
    b = leave.shape[0]

    def run_chunk(ft_in, limits_vec, T):
        limits = torch.from_numpy(limits_vec).to(device)
        return chunk_op(g0p, g1p, ft_in, site_weight, leave, limits, n_p, T,
                        fast_math)

    ft = torch.full((b, m), 0.25, dtype=_F32, device=device)
    ft, iters, active = _drive_chunks(
        run_chunk, None, ft, b, max_iter, tol, m_real, chunk, None, reduce,
        name="zloo_chunk",
    )
    return ft, iters, ~active


def em_maf_sites_batch_fused(
    g0p,
    g1p,
    member_mask,
    site_weight,
    m_real,
    max_iter: int,
    tol: float,
    chunk: int = 8,
    fast_math: bool = True,
    chunk_op=sites_chunk,
    reduce=None,
):
    """B independent one-population EMs over gathered ``[B, P, S]`` member
    panels, in chunks of ``chunk`` fused iterations (the z-score reference
    mode's gathered form).

    Same contract as the plain :func:`wgsassign_tpu_torch.ops.emmaf.
    em_maf_sites_batch`: ``member_mask`` ``[B, P]``, ``site_weight``
    ``[B, S]``, ``m_real`` the ``[B]`` real-site counts; returns ``(f [B,
    S] on the device, iters [B] int32, converged [B] bool)``.
    ``fast_math``, ``chunk_op`` and ``reduce`` as in
    :func:`em_maf_pops_fused`.
    """
    b, _p, s = g0p.shape
    device = g0p.device
    mask_h = np.asarray(member_mask, np.float32)
    # 1 / count in float32, as the JAX package's driver computes it
    inv_h = (1.0 / np.maximum(mask_h.sum(axis=1), 1.0)).astype(np.float32)
    mask = torch.from_numpy(mask_h).to(device)
    inv_counts = torch.from_numpy(inv_h).to(device)
    sw = torch.as_tensor(site_weight, dtype=_F32, device=device)

    def run_chunk(ft_in, limits_vec, T):
        limits = torch.from_numpy(limits_vec).to(device)
        return chunk_op(g0p, g1p, ft_in, mask, sw, limits, inv_counts, T,
                        fast_math)

    ft = torch.full((b, s), 0.25, dtype=_F32, device=device)
    ft, iters, active = _drive_chunks(
        run_chunk, None, ft, b, max_iter, tol, m_real, chunk, None, reduce,
        name="sites_chunk",
    )
    return ft, iters, ~active
