"""Batched sums of the assignment z statistic on the device (counterpart of
``wgsassign_tpu/ops/zscore_ops.py::zscore_sums_batch_compact``).

Per kept site ``s`` of individual ``b`` with AF ``a`` and HWE genotype
prior ``P = [(1-a)^2, 2a(1-a), a^2]``:

  observed:   W_obs  = sum_s log(GL_s . P_s)
  expected:   W_mu_s = sum_{splits x of depth D_s} lg(s, x) * wt(s, x)
  variance:   V_s    = sum_x (W_mu_s - lg(s, x))^2 * wt(s, x)

with ``lg = log(meanGL[row] . P_s)`` and ``wt = readProb[row] . P_s`` for the
combo-table row ``rows_by_depth[b, D_s, x]`` of split ``(D_s - x, x)``.

The JAX package loops over (depth d, split x) with scalar table rows, which
suits the TPU's vector unit.  Here the loop runs over the split ``x`` only:
each site gathers its own depth's row for that split, and the term is added
where ``x <= D_s``.  A site's splits are still summed in ascending ``x``, so
the values match the JAX op to rounding, with C instead of ~C^2 / 2 passes.

The callers hold a group's kept sites as slots: ``keep [G, S]`` site
indices of the cohort's planes, each individual's first ``s_local[b]``
slots real and the rest padding.  :func:`kept_slot_sums` sums a group's
three z sums from there.  On a GPU that is the hand-written kernel
``csrc/zsums.cu`` (:func:`zsums`): one read of each kept slot's GLs, depths
and AF, the splits of the slot's own depth only, each float32 term as
:func:`zscore_sums_batch_compact` forms it, sums in a fixed order.  The
twin (:func:`kept_slot_sums_twin`) gathers blocks of individuals' slots
into ``[B, S]`` operands of :func:`zscore_sums_batch_compact`; it runs for
CPU tensors, and on the card where the caller passes ``kernel=False`` (the
runtime's ``--no_pallas``).
"""

from __future__ import annotations

import numpy as np
import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.obs.profiling import count
from wgsassign_tpu_torch.ops import log
from wgsassign_tpu_torch.ops.ztables import AD_TYPES

# The kernel's launch (csrc/zsums.cu): ZSUMS_THREADS threads a block, one
# individual and one chunk of slots a block, about ZSUMS_BLOCKS blocks a
# launch, chunks of at least ZSUMS_MIN_CHUNK slots.  A block's tables are
# staged in shared memory up to ZSUMS_STAGE_BYTES (four blocks an SM), else
# read from global memory.  Split counts up to ZSUMS_UNROLLED keep their
# per-split terms in registers.
ZSUMS_THREADS = 256
ZSUMS_BLOCKS = 8192
ZSUMS_MIN_CHUNK = 4 * ZSUMS_THREADS
ZSUMS_STAGE_BYTES = _kernels.SMEM_LIMIT // 4
ZSUMS_UNROLLED = 16


def zscore_sums_batch_compact(g0k, g1k, a, weight, site_depth,
                              rows_by_depth, like_tab, fact_tab,
                              sum_dtype=None):
    """Masked z sums for a block of B individuals.

    Args:
      g0k, g1k: float32 ``[B, S]`` kept-site GLs of each individual.
      a: float32 ``[B, S]`` AF at the kept sites.
      weight: float32 ``[B, S]``, 1.0 on real kept sites.
      site_depth: integer ``[B, S]`` total read depth per kept site.
      rows_by_depth: integer ``[B, C, C]`` combo row of split x at depth d.
      like_tab: float32 ``[B, R, 3]`` mean GL triple per combo.
      fact_tab: float32 ``[B, R, 3]`` read probability per combo.

      sum_dtype: dtype the per-site float32 terms are summed in; None is
        float32, as the JAX op sums them.  float64 is for checks that
        separate the rounding of these sums from other differences.

    Returns ``(w_obs, w_mu, w_var)``, three ``[B]`` tensors (float32, or
    ``sum_dtype``).
    """
    b, c, _ = rows_by_depth.shape
    p0 = (1.0 - a) * (1.0 - a)
    p1 = 2.0 * (1.0 - a) * a
    p2 = a * a
    w_obs_site = log(g0k * p0 + g1k * p1 + (1.0 - g0k - g1k) * p2)

    depth = site_depth.long()
    rbd = rows_by_depth.reshape(b, c * c).long()
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    terms = []
    w_mu_site = torch.zeros_like(a)
    for x in range(c):
        valid = depth >= x
        rows = torch.gather(rbd, 1, depth * c + x)  # [B, S]
        mg = [torch.gather(like_tab[:, :, k], 1, rows) for k in range(3)]
        rp = [torch.gather(fact_tab[:, :, k], 1, rows) for k in range(3)]
        lg = log(mg[0] * p0 + mg[1] * p1 + mg[2] * p2)
        wt = rp[0] * p0 + rp[1] * p1 + rp[2] * p2
        terms.append((valid, lg, wt))
        w_mu_site = w_mu_site + torch.where(valid, lg * wt, zero)
    w_var_site = torch.zeros_like(a)
    for valid, lg, wt in terms:
        dv = w_mu_site - lg
        w_var_site = w_var_site + torch.where(valid, dv * dv * wt, zero)

    return (torch.sum(w_obs_site * weight, dim=1, dtype=sum_dtype),
            torch.sum(w_mu_site * weight, dim=1, dtype=sum_dtype),
            torch.sum(w_var_site * weight, dim=1, dtype=sum_dtype))


def zsums_geometry(g: int, s_max: int, c: int, r: int) -> tuple:
    """``(chunk, n_chunks, smem_bytes, cmax)`` of the kernel's launch for
    ``g`` individuals with at most ``s_max`` kept slots each and tables of
    ``c`` depths and ``r`` combo rows.  Chunks are multiples of
    ZSUMS_THREADS slots, as many as make about ZSUMS_BLOCKS blocks;
    ``smem_bytes`` is the staged tables' size, or 0 above
    ZSUMS_STAGE_BYTES; ``cmax`` is ZSUMS_UNROLLED where it holds ``c``
    splits, else 0 (the variance pass forms the terms again)."""
    if g < 1 or c < 1 or r < 1:
        raise ValueError(f"zsums: no launch for g={g}, c={c}, r={r}")
    per = max(1, ZSUMS_BLOCKS // g)
    chunk = max(ZSUMS_MIN_CHUNK, -(-max(s_max, 1) // per))
    chunk = -(-chunk // ZSUMS_THREADS) * ZSUMS_THREADS
    n_chunks = max(1, -(-s_max // chunk))
    tables = 4 * (c * c + 6 * r)
    smem = tables if tables <= ZSUMS_STAGE_BYTES else 0
    cmax = ZSUMS_UNROLLED if c <= ZSUMS_UNROLLED else 0
    return chunk, n_chunks, smem, cmax


def zsums(g0, g1, counts, col0: int, keep, a, s_local, rows_by_depth,
          mean_gl, read_probs, dtype):
    """``[3, G]`` sums ``(w_obs, w_mu, w_var)`` of individuals ``col0 ..
    col0 + G`` by the ``zsums`` kernel, in ``dtype`` (float64, or float32
    for ``--f32_sums``): the sums of :func:`kept_slot_sums_twin` over the
    same float32 terms, added in the kernel's fixed order.

    Args (CUDA tensors, contiguous but ``keep``):
      g0, g1: float32 ``[M, N]`` GL planes.
      counts: uint8 or int32 ``[M, 2N]`` read counts (``DeviceDepths``).
      keep: int64 ``[G, S]`` kept-site indices, each in ``[0, M)`` where
        the slot is real; rows may lie further apart than S (a column
        slice of a wider slot table), slots must be adjacent.
      a: float32 ``[G, S]`` AF at the kept slots.
      s_local: ``[G]`` host integers, each in ``[0, S]``: individual b's
        real slots are its first ``s_local[b]``; the rest are not read.
      rows_by_depth: int32 ``[G, C, C]``; mean_gl, read_probs: float32
        ``[G, R, 3]`` (a row outside ``[0, R)`` or a depth outside
        ``[0, C)`` makes that individual's w_mu and w_var NaN).
    """
    dev = g0.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"zsums: sums in {dtype}, expected float32 or "
                         "float64")
    if counts.dtype not in AD_TYPES:
        raise ValueError(f"counts have dtype {counts.dtype}, expected one "
                         f"of {sorted(map(str, AD_TYPES))}")
    m, n = g0.shape
    g, s = keep.shape
    c, r = rows_by_depth.shape[1], mean_gl.shape[1]
    for name, t, want_dtype, shape in (
            ("g0", g0, torch.float32, (m, n)),
            ("g1", g1, torch.float32, (m, n)),
            ("counts", counts, counts.dtype, (m, 2 * n)),
            ("a", a, torch.float32, (g, s)),
            ("rows_by_depth", rows_by_depth, torch.int32, (g, c, c)),
            ("mean_gl", mean_gl, torch.float32, (g, r, 3)),
            ("read_probs", read_probs, torch.float32, (g, r, 3))):
        _kernels.check_operand(name, t, dev, want_dtype, shape)
    if keep.device != dev or keep.dtype != torch.int64:
        raise ValueError(f"keep is {keep.dtype} on {keep.device}, expected "
                         f"torch.int64 on {dev}")
    ldk = keep.stride(0)  # rows ldk >= S apart, slots adjacent
    if keep.stride(1) != 1 or (g > 1 and ldk < s):
        raise ValueError("keep must have adjacent slots and rows at least "
                         f"{s} apart, not strides {keep.stride()}")
    s_local = np.asarray(s_local, dtype=np.int64)
    if s_local.shape != (g,) or (g and not (
            0 <= s_local.min() and s_local.max() <= s)):
        raise ValueError(f"s_local must be {g} counts in [0, {s}]")
    if not 0 <= col0 <= n - g:
        raise ValueError(f"columns [{col0}, {col0 + g}) outside the "
                         f"cohort's {n}")
    if dev.type != "cuda":
        raise ValueError(f"zsums: no kernel for device {dev}")
    chunk, n_chunks, smem, cmax = zsums_geometry(g, int(s_local.max()), c, r)
    s_dev = torch.from_numpy(s_local.astype(np.int32)).to(dev)
    part = torch.empty((n_chunks, g, 3), dtype=dtype, device=dev)
    out = torch.empty((3, g), dtype=dtype, device=dev)
    _kernels.launch(
        "zsums", dev, g0.data_ptr(), g1.data_ptr(), counts.data_ptr(),
        keep.data_ptr(), a.data_ptr(), s_dev.data_ptr(),
        rows_by_depth.data_ptr(), mean_gl.data_ptr(), read_probs.data_ptr(),
        part.data_ptr(), out.data_ptr(), n, col0, g, s, ldk, c, r, chunk,
        n_chunks, cmax, smem, AD_TYPES[counts.dtype],
        int(dtype == torch.float64),
    )
    count("zsums.launches")
    return out


def kept_slot_sums_twin(g0, g1, counts, col0: int, keep, a, s_local,
                        rows_by_depth, mean_gl, read_probs, dtype,
                        block=None):
    """:func:`zsums` by plain ops: blocks of ``block`` individuals (all at
    once for None), each gathered into ``[block, S]`` operands of
    :func:`zscore_sums_batch_compact` with weight 1.0 on the real slots."""
    g, s = keep.shape
    dev = a.device
    b = g if block is None else max(1, int(block))
    ad = counts.view(counts.shape[0], -1, 2)
    s_loc = torch.as_tensor(np.asarray(s_local, dtype=np.int64), device=dev)
    slots = torch.arange(s, device=dev)
    out = torch.empty((3, g), dtype=dtype, device=dev)
    for lo in range(0, g, b):
        hi = min(lo + b, g)
        k = keep[lo:hi]
        cols = torch.arange(col0 + lo, col0 + hi, device=dev)[:, None]
        w = (slots < s_loc[lo:hi, None]).to(torch.float32)
        depth = (ad[k, cols, 0].to(torch.int32)
                 + ad[k, cols, 1].to(torch.int32))
        out[:, lo:hi] = torch.stack(zscore_sums_batch_compact(
            g0[k, cols], g1[k, cols], a[lo:hi], w,
            torch.where(w > 0, depth, 0), rows_by_depth[lo:hi],
            mean_gl[lo:hi], read_probs[lo:hi], sum_dtype=dtype))
    return out


def kept_slot_sums(g0, g1, counts, col0: int, keep, a, s_local,
                   rows_by_depth, mean_gl, read_probs, dtype, block=None,
                   kernel=True):
    """``[3, G]`` z sums ``(w_obs, w_mu, w_var)`` in ``dtype`` of a group
    of individuals' kept slots (operands as for :func:`zsums`): one
    :func:`zsums` launch for CUDA tensors, the twin in blocks of ``block``
    individuals for CPU tensors or ``kernel=False`` (``--no_pallas``).

    Counts ``zscore.blocks`` (a launch, or each twin block),
    ``zscore.kept_slots`` (the real slots) and ``zscore.launched_slots``,
    the slots the sums cover: the launch's grid (each individual's chunks,
    also those past its kept count), or the twin's whole padded rows."""
    g, s = keep.shape
    if kernel and g0.device.type == "cuda":
        out = zsums(g0, g1, counts, col0, keep, a, s_local, rows_by_depth,
                    mean_gl, read_probs, dtype)
        chunk, n_chunks, _, _ = zsums_geometry(
            g, int(np.max(s_local)), rows_by_depth.shape[1],
            mean_gl.shape[1])
        blocks, launched = 1, g * n_chunks * chunk
    else:
        out = kept_slot_sums_twin(g0, g1, counts, col0, keep, a, s_local,
                                  rows_by_depth, mean_gl, read_probs, dtype,
                                  block)
        blocks = -(-g // (g if block is None else max(1, int(block))))
        launched = g * s
    count("zscore.blocks", blocks)
    count("zscore.launched_slots", launched)
    count("zscore.kept_slots", int(np.sum(s_local)))
    return out
