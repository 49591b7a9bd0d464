"""One leave-one-out EM iteration of B z-score problems of one population,
in place: the CUDA kernel (``csrc/zloo_chunk.cu``) and its plain PyTorch
twin.

Counterpart of ``zloo_chunk_pallas`` / ``_zloo_chunk_kernel`` in
``wgsassign_tpu/ops/pallas_emmaf.py``, which fuse T iterations a launch:
problem b leaves out member ``leave[b]`` and takes ``min(T, limits[b])``
updates
``f_b <- clip(sum_{i != leave[b], i < n_real} w(g_i, f_b) / (n_real - 1))``
over the full site axis; its kept-site mask ``sw[b]`` enters only
``sq[t, b] = sum_s d * d * sw[b, s]``.  Rows of the member panel at or past
``n_real`` are padding.  The twin (:func:`zloo_chunk_twin`) keeps that chunk
contract; the kernel runs one iteration a launch (T = 1), which the EM
driver tests for convergence on the device before the next
(``ops/fused_em.py::_drive_steps``).

:func:`zloo_step` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import em_w
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS

_F32 = torch.float32

# The kernel's tile (csrc/zloo_chunk.cu), the one of ``loo_chunk``: a block
# stages the [n_real, 32] tile of both GL panels in shared memory (a
# population too large for that is read from the global panels instead, in
# the same order); a warp carries ZLOO_PROBLEM_TILE problems through the
# member loop at once, and the block's warps take the problem tiles
# round-robin.
ZLOO_SITES = 32
ZLOO_PROBLEM_TILE = 4
ZLOO_MAX_WARPS = 8


def _smem_bytes(n_real: int) -> int:
    return 4 * 2 * n_real * ZLOO_SITES


def max_zloo_members() -> int:
    """Largest population whose [n_real, 32] member tile is staged in
    shared memory: 908, whatever the chunk length and the number of
    problems.  A larger one runs the kernel's unstaged form
    (:func:`zloo_chunk_geometry`)."""
    return _kernels.SMEM_LIMIT // (4 * 2 * ZLOO_SITES)


def zloo_chunk_geometry(n_real: int, b: int) -> tuple:
    """``(warps, smem_bytes)`` of a block.  The ``b`` problems make
    ``ceil(b / ZLOO_PROBLEM_TILE)`` tiles, the last one ragged, taken
    round-robin by the block's warps.  The warp count (at most
    ZLOO_MAX_WARPS) is the one with the best product of two estimates: the
    share of the warps' time that carries a problem (the block lasts as long
    as its most loaded warp), and the share of 32 resident warps per SM that
    the shared memory allows; the fewest warps on a tie (13 problems: 3
    warps with 5, 4 and 4).  Above :func:`max_zloo_members` the tile does
    not fit: the block takes no shared memory (``smem_bytes == 0`` selects
    the kernel that reads the members from the global panels), which leaves
    the registers to bound the resident warps."""
    staged = n_real <= max_zloo_members()
    smem = _smem_bytes(n_real) if staged else 0
    sizes = [min(ZLOO_PROBLEM_TILE, b - lo)
             for lo in range(0, b, ZLOO_PROBLEM_TILE)]
    # resident blocks per SM: 32 at most, 1 KB of shared memory reserved each
    blocks = min(32, max(1, _kernels.SMEM_LIMIT // (smem + 1024)))

    def score(w):
        busiest = max(1, *(sum(sizes[i::w]) for i in range(w)))
        return (b / (w * busiest)) * min(1.0, w * blocks / 32)

    top = min(ZLOO_MAX_WARPS, max(1, len(sizes)))
    warps = max(range(1, top + 1), key=lambda w: (score(w), -w))
    return warps, smem


def zloo_chunk_twin(g0p, g1p, ft, sw, leave, limits, n_real: int, T: int,
                    fast_math: bool = True):
    """Plain PyTorch version of T fused iterations, returning ``(ft_new
    [B, M], sq [T, B])`` in fresh tensors (arguments as :func:`zloo_step`,
    limits up to T).  At T = 1 it is the kernel's iteration, with the
    blocks' partials summed.  Loops over members in ascending order, adding
    member i's weights under every problem's AF with the problems that
    leave i out masked, so no ``[B, n_p, M]`` tensor is built."""
    b = ft.shape[0]
    leave = leave.long()
    inv = 1.0 / (torch.tensor(float(n_real), dtype=_F32) - 1.0)
    f = ft.clone()
    sq = torch.empty((T, b), dtype=_F32, device=ft.device)
    for t in range(T):
        acc = torch.zeros_like(f)
        for i in range(n_real):
            keep = (leave != i).to(_F32)[:, None]
            a, c = g0p[i], g1p[i]
            acc += em_w(a, c, 1.0 - a - c, f, fast_math) * keep
        f_upd = torch.clamp(acc * inv.to(ft.device), _EM_EPS, 1.0 - _EM_EPS)
        f_new = torch.where(limits[:, None] > t, f_upd, f)
        d = f_new - f
        sq[t] = torch.sum(d * d * sw, dim=1)
        f = f_new
    return f, sq


def zloo_step(g0p, g1p, ft, sw, leave, limits, n_real: int,
              fast_math: bool = True):
    """One LOO-subset EM iteration for B problems of one population, in
    place in ``ft``.

    Args:
      g0p, g1p: float32 ``[np_pad, M]`` member GL panels, site-minor;
        padded sites hold the (1, 0) GL pattern, rows >= ``n_real`` are
        padding.
      ft: float32 ``[B, M]`` per-problem AF, updated in place.
      sw: float32 ``[B, M]`` per-problem kept-site masks (0 on padding).
      leave: int32 ``[B]`` member row each problem leaves out (a row
        outside ``[0, n_real)`` leaves nothing out).
      limits: float32 ``[B]``: a problem with a limit above 0 takes the
        update; a stopped one (0) keeps its row and its ``sw`` is not read.
      n_real: real member count (<= np_pad); the divisor is ``n_real - 1``.

    Returns the squared-update partials that :class:`wgsassign_tpu_torch.
    ops.em_decide.Convergence` sums: the kernel's ``[blocks, B]`` (a block
    in which every limit is 0 returns at once and writes none of them), the
    twin's ``[1, B]``.
    """
    if g0p.device.type == "cpu":
        f, sq = zloo_chunk_twin(g0p, g1p, ft, sw, leave, limits, n_real, 1,
                                fast_math)
        ft.copy_(f)
        return sq
    if g0p.device.type != "cuda":
        raise ValueError(f"zloo_chunk: no kernel for device {g0p.device}")
    np_pad, m = g0p.shape
    b = ft.shape[0]
    dev = g0p.device
    if not 2 <= n_real <= np_pad:
        raise ValueError(f"zloo_chunk: n_real={n_real} outside [2, {np_pad}]")
    for name, t, dtype, shape in (
        ("g0p", g0p, _F32, (np_pad, m)), ("g1p", g1p, _F32, (np_pad, m)),
        ("ft", ft, _F32, (b, m)), ("sw", sw, _F32, (b, m)),
        ("leave", leave, torch.int32, (b,)), ("limits", limits, _F32, (b,)),
    ):
        _kernels.check_operand(name, t, dev, dtype, shape)
    warps, smem = zloo_chunk_geometry(n_real, b)
    n_blocks = -(-m // ZLOO_SITES)
    aligned = _kernels.rows_aligned(m, g0p, g1p)
    # the kernel visits the problems by limit, largest first: the problems
    # still running then form a prefix of each of its problem tiles
    order = torch.argsort(limits, descending=True, stable=True).to(
        torch.int32)
    sq_part = torch.empty((n_blocks, b), dtype=_F32, device=dev)
    _kernels.launch(
        "zloo_chunk", dev, g0p.data_ptr(), g1p.data_ptr(), ft.data_ptr(),
        sw.data_ptr(), leave.data_ptr(), order.data_ptr(),
        limits.data_ptr(), sq_part.data_ptr(), b, m, n_real, warps, smem,
        int(aligned), int(bool(fast_math)),
    )
    return sq_part
