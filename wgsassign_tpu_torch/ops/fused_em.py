"""Chunked fused EMs (counterpart of ``em_maf_pops_fused`` and
``em_maf_loo_group_fused`` in ``wgsassign_tpu/ops/pallas_emmaf.py``).

Each chunk runs T EM iterations in one kernel launch (:func:`em_chunk`,
:func:`loo_chunk`), which also returns the per-iteration squared-update
sums ``sq[T, P]``.  The host rebuilds each problem's exact RMSE sequence
from ``sq``; when a problem converges inside a chunk, the chunk is replayed
from its snapshot with exact per-problem limits, so every problem stops at
the iteration an independent serial run would (``_drive_chunks``, copied
from the JAX package).  ``sq`` reaches the host once per chunk; the AF
panels stay on the device.

Padded sites start at ``_EM_EPS``, the fixed point of the (1, 0) padding GL
pattern, so they add exactly 0 to every ``sq``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wgsassign_tpu_torch.ops.em_chunk import em_chunk
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS
from wgsassign_tpu_torch.ops.loo_chunk import loo_chunk

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
    twin where a check on the GPU compares the two.
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
        # a JAX-written file carries the lane-padded panel: crop it
        return torch.from_numpy(np.ascontiguousarray(arr[:k, :m])).to(device)

    def run_chunk(ft_in, limits_vec, T):
        limits = torch.from_numpy(limits_vec).to(device)
        return chunk_op(g0, g1, ft_in, pop_index, inv_counts, limits, T,
                        fast_math)

    ft = _device_init_ft_from_weight(site_weight, (k, m))
    _use_jax_layout(checkpoint, k, m_real)
    ft, iters, active = _drive_chunks(
        run_chunk, put_ft, ft, k, max_iter, tol, m_real, chunk, checkpoint
    )
    if return_device_panel:
        return ft, iters, ~active
    f = np.ascontiguousarray(ft.t().cpu().numpy())
    return f, iters, ~active


def _drive_chunks(run_chunk, put_ft, ft, n_problems, max_iter, tol, m_real,
                  chunk, checkpoint):
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
    vector (per-problem site counts).

    Returns ``(ft, iters [P] int32, active [P] bool)``.
    """
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
        T = min(chunk, max_iter - it)
        limits_vec = np.where(active, T, 0).astype(np.float32)
        ft_snapshot = ft
        ft, sq = run_chunk(ft, limits_vec, T)
        # the one device->host sync of the chunk
        rmse = np.sqrt(np.maximum(sq.cpu().numpy(), 0.0) / m_real_vec[None, :])
        # first iteration (within chunk) at which each active problem converged
        crossed = rmse < tol  # [T, P]
        exact_limits = limits_vec.copy()
        replay = False
        for kk in range(n_problems):
            if not active[kk]:
                continue
            hits = np.flatnonzero(crossed[:T, kk])
            if hits.size:
                t_star = int(hits[0]) + 1  # updates taken when it converged
                iters[kk] = it + t_star
                active[kk] = False
                if t_star < T:
                    exact_limits[kk] = t_star
                    replay = True
        if replay:
            ft, _ = run_chunk(ft_snapshot, exact_limits, T)
        it += T
        if checkpoint is not None:
            checkpoint.maybe_save(ft, iters, active, it)
    if checkpoint is not None:
        checkpoint.clear()
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
):
    """Batched leave-one-out EM for one population in chunks of ``chunk``
    fused iterations.

    Same contract as the plain :func:`wgsassign_tpu_torch.ops.emmaf.
    em_maf_loo_group`: ``g0p``/``g1p`` are the members' ``[n_p, M]`` GL
    panels (sites >= ``m_real`` hold the (1, 0) padding pattern); returns
    ``(f [n_p, M] on the device, iters [n_p] int32, converged [n_p] bool)``.
    ``fast_math`` and ``chunk_op`` as in :func:`em_maf_pops_fused`.
    """
    n_p, m = g0p.shape
    device = g0p.device

    def put_ft(arr):
        # a JAX-written file carries padded problem rows and sites: crop
        return torch.from_numpy(
            np.ascontiguousarray(arr[:n_p, :m])).to(device)

    def run_chunk(ft_in, limits_vec, T):
        limits = torch.from_numpy(limits_vec).to(device)
        return chunk_op(g0p, g1p, ft_in, limits, n_p, T, fast_math)

    ft = _device_init_ft((n_p, m), m_real, device)
    _use_jax_layout(checkpoint, -(-n_p // 8) * 8, m_real)
    ft, iters, active = _drive_chunks(
        run_chunk, put_ft, ft, n_p, max_iter, tol, m_real, chunk, checkpoint
    )
    return ft, iters, ~active
