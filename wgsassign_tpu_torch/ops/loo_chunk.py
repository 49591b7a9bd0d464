"""One leave-one-out EM iteration for one population, in place: the CUDA
kernel (``csrc/loo_chunk.cu``) and its plain PyTorch twin.

Counterpart of ``loo_chunk_pallas`` / ``_loo_chunk_kernel`` in
``wgsassign_tpu/ops/pallas_emmaf.py``, which fuse T iterations a launch:
problem j (member j left out) takes ``min(T, limits[j])`` updates
``f_j <- clip(sum_{i != j, i < n_real} w(g_i, f_j) / (n_real - 1))``, and
``sq[t, j]`` is its squared update of iteration t summed over the sites.
``n_real`` is a run-time value; rows at or past it are padding.  The twin
(:func:`loo_chunk_twin`) keeps that chunk contract; the kernel runs one
iteration a launch (T = 1), which the EM driver tests for convergence on
the device before the next (``ops/fused_em.py::_drive_steps``).

:func:`loo_step` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import em_w
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS

_F32 = torch.float32

# The kernel's tile (csrc/loo_chunk.cu): a block stages the [n_real, 32] tile
# of both GL panels in shared memory (a population too large for that is
# read from the global panels instead, in the same order); a warp carries
# LOO_PROBLEM_TILE problems through the member loop at once, and the block's
# warps take the problem tiles round-robin.
LOO_SITES = 32
LOO_PROBLEM_TILE = 4
LOO_MAX_WARPS = 8


def _smem_bytes(n_real: int) -> int:
    return 4 * 2 * n_real * LOO_SITES


def max_loo_members() -> int:
    """Largest population whose [n_real, 32] member tile is staged in
    shared memory: 908, whatever the chunk length.  A larger one runs the
    kernel's unstaged form (:func:`loo_chunk_geometry`)."""
    return _kernels.SMEM_LIMIT // (4 * 2 * LOO_SITES)


def loo_chunk_geometry(n_real: int) -> tuple:
    """``(warps, smem_bytes)`` of a block.  The real problems make
    ``ceil(n_real / LOO_PROBLEM_TILE)`` tiles, taken round-robin by the
    block's warps.  The warp count (at most LOO_MAX_WARPS) is the one with
    the best product of two estimates: the share of warp rounds that carry
    a tile, and the share of 32 resident warps per SM that the shared
    memory allows; the fewest warps on a tie (9 tiles: 3 warps, three rounds
    each).  Above :func:`max_loo_members` the tile does not fit: the block
    takes no shared memory (``smem_bytes == 0`` selects the kernel that
    reads the members from the global panels) and LOO_MAX_WARPS warps, since
    nothing but registers bounds the resident warps then."""
    if n_real > max_loo_members():
        return LOO_MAX_WARPS, 0
    smem = _smem_bytes(n_real)
    tiles = -(-n_real // LOO_PROBLEM_TILE)
    # resident blocks per SM: 32 at most, 1 KB of shared memory reserved each
    blocks = min(32, max(1, _kernels.SMEM_LIMIT // (smem + 1024)))

    def score(w):
        return (tiles / (-(-tiles // w) * w)) * min(1.0, w * blocks / 32)

    warps = max(range(1, LOO_MAX_WARPS + 1), key=lambda w: (score(w), -w))
    return warps, smem


def loo_chunk_twin(g0p, g1p, ft, limits, n_real: int, T: int,
                   fast_math: bool = True):
    """Plain PyTorch version of T fused iterations, returning ``(ft_new
    [P, M], sq [T, P])`` in fresh tensors (arguments as :func:`loo_step`,
    limits up to T).  At T = 1 it is the kernel's iteration, with the
    blocks' partials summed.  Loops over members in ascending order, adding
    member i's weights under every problem's AF with problem i masked out,
    so no ``[P, P, M]`` tensor is built."""
    p = ft.shape[0]
    rows = torch.arange(p, device=ft.device)
    inv = 1.0 / (torch.tensor(float(n_real), dtype=_F32) - 1.0)
    f = ft.clone()
    sq = torch.empty((T, p), dtype=_F32, device=ft.device)
    for t in range(T):
        acc = torch.zeros_like(f)
        for i in range(n_real):
            keep = (rows != i).to(_F32)[:, None]
            a, b = g0p[i], g1p[i]
            acc += em_w(a, b, 1.0 - a - b, f, fast_math) * keep
        f_upd = torch.clamp(acc * inv.to(ft.device), _EM_EPS, 1.0 - _EM_EPS)
        f_new = torch.where(limits[:, None] > t, f_upd, f)
        d = f_new - f
        sq[t] = torch.sum(d * d, dim=1)
        f = f_new
    return f, sq


def loo_step(g0p, g1p, ft, limits, n_real: int, fast_math: bool = True):
    """One LOO EM iteration for one population, in place in ``ft``.

    Args:
      g0p, g1p: float32 ``[P, M]`` member GL panels, site-minor; padded
        sites hold the (1, 0) GL pattern.
      ft: float32 ``[P, M]`` per-problem AF (padded sites at ``_EM_EPS``),
        updated in place.
      limits: float32 ``[P]``: a problem with a limit above 0 takes the
        update; a stopped one (0, as padded problem rows) keeps its row.
      n_real: real member count (<= P); the divisor is ``n_real - 1``.

    Returns the squared-update partials that :class:`wgsassign_tpu_torch.
    ops.em_decide.Convergence` sums: the kernel's ``[blocks, P]`` (a block
    in which every limit is 0 returns at once and writes none of them), the
    twin's ``[1, P]``.
    """
    if g0p.device.type == "cpu":
        f, sq = loo_chunk_twin(g0p, g1p, ft, limits, n_real, 1, fast_math)
        ft.copy_(f)
        return sq
    if g0p.device.type != "cuda":
        raise ValueError(f"loo_chunk: no kernel for device {g0p.device}")
    p, m = ft.shape
    dev = g0p.device
    if not 2 <= n_real <= p:
        raise ValueError(f"loo_chunk: n_real={n_real} outside [2, {p}]")
    for name, t, shape in (("g0p", g0p, (p, m)), ("g1p", g1p, (p, m)),
                           ("ft", ft, (p, m)), ("limits", limits, (p,))):
        _kernels.check_operand(name, t, dev, _F32, shape)
    warps, smem = loo_chunk_geometry(n_real)
    n_blocks = -(-m // LOO_SITES)
    aligned = _kernels.rows_aligned(m, g0p, g1p)
    sq_part = torch.empty((n_blocks, p), dtype=_F32, device=dev)
    _kernels.launch(
        "loo_chunk", dev, g0p.data_ptr(), g1p.data_ptr(), ft.data_ptr(),
        limits.data_ptr(), sq_part.data_ptr(), p, m, n_real, warps, smem,
        int(aligned), int(bool(fast_math)),
    )
    return sq_part
