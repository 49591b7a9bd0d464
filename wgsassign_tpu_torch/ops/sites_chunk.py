"""One chunk of T fused iterations of B independent EMs over gathered
member panels: the CUDA kernel (``csrc/sites_chunk.cu``) and its plain
PyTorch twin.

Counterpart of ``sites_chunk_pallas`` / ``_sites_chunk_kernel`` in
``wgsassign_tpu/ops/pallas_emmaf.py``: problem b has its own ``[P, S]``
member panel, member mask, site weight and ``1/count``, and takes
``min(T, limits[b])`` updates
``f_b <- clip((sum_p w(g_bp, f_b) * mask[b, p]) * inv_counts[b])``;
``sq[t, b] = sum_s d * d * site_weight[b, s]``.

:func:`sites_chunk` launches the kernel for CUDA tensors and runs the twin
for CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import em_w
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS

_F32 = torch.float32

# The kernel's tile (csrc/sites_chunk.cu): a block is one problem and
# 32 * warps site slots, one thread a site, and stages its [P, tile] slice of
# the problem's panels in shared memory as SITES_PLANES planes, beside a
# bitmap of the member mask (8 bytes per 32 members and 8 more); a panel of
# too many members for that is read from global memory instead, in the same
# order.  SITES_WARPS are the block widths the kernel is built for, widest
# first.
SITES_WARPS = (4, 2, 1)
SITES_PLANES = 2


def _smem_bytes(p: int, warps: int) -> int:
    words = -(-p // 32)
    return 4 * (SITES_PLANES * p * 32 * warps + 2 * words + 2)


def max_sites_members() -> int:
    """Largest member panel (P rows) whose slice of the narrowest tile is
    staged in shared memory: 907, whatever the chunk length and the number
    of problems.  A larger one runs the kernel's unstaged form
    (:func:`sites_chunk_geometry`)."""
    warps = SITES_WARPS[-1]
    p = _kernels.SMEM_LIMIT // (4 * SITES_PLANES * 32 * warps)
    while _smem_bytes(p, warps) > _kernels.SMEM_LIMIT:
        p -= 1
    return p


def sites_chunk_geometry(p: int) -> tuple:
    """``(warps, smem_bytes)`` of a block: the width with the most warps
    resident on an SM (at most 32 blocks and 64 warps; 1 KB of shared memory
    reserved a block), the widest on a tie, since wider tiles make fewer
    blocks to launch.  Above :func:`max_sites_members` no width fits: the
    block takes no shared memory (``smem_bytes == 0`` selects the kernel that
    reads the members from the global panels) at the widest tile."""
    def resident(w):
        blocks = max(1, _kernels.SMEM_LIMIT // (_smem_bytes(p, w) + 1024))
        return min(64, w * min(32, blocks))

    if p > max_sites_members():
        return SITES_WARPS[0], 0
    fits = [w for w in SITES_WARPS
            if _smem_bytes(p, w) <= _kernels.SMEM_LIMIT]
    warps = max(fits, key=lambda w: (resident(w), w))
    return warps, _smem_bytes(p, warps)


def sites_chunk_twin(g0p, g1p, ft, member_mask, site_weight, limits,
                     inv_counts, T: int, fast_math: bool = True):
    """Plain PyTorch version of the chunk, same signature and result as
    :func:`sites_chunk`.  Members are summed in ascending order, one
    ``[B, S]`` weight at a time."""
    b, p, s = g0p.shape
    f = ft.clone()
    sq = torch.empty((T, b), dtype=_F32, device=ft.device)
    for t in range(T):
        acc = torch.zeros_like(f)
        for i in range(p):
            a, c = g0p[:, i], g1p[:, i]
            acc += em_w(a, c, 1.0 - a - c, f, fast_math) * member_mask[:, i, None]
        f_upd = torch.clamp(acc * inv_counts[:, None], _EM_EPS, 1.0 - _EM_EPS)
        f_new = torch.where(limits[:, None] > t, f_upd, f)
        d = f_new - f
        sq[t] = torch.sum(d * d * site_weight, dim=1)
        f = f_new
    return f, sq


def sites_chunk(g0p, g1p, ft, member_mask, site_weight, limits, inv_counts,
                T: int, fast_math: bool = True):
    """T fused sites-batch EM iterations for B problems.

    Args:
      g0p, g1p: float32 ``[B, P, S]`` gathered member GL panels (padded
        site slots carry a valid GL pattern).
      ft: float32 ``[B, S]`` per-problem AF.
      member_mask: float32 ``[B, P]``, 1 where the member takes part.
      site_weight: float32 ``[B, S]``, 1 on real kept sites.
      limits: float32 ``[B]`` per-problem update limits (<= T).
      inv_counts: float32 ``[B]`` per-problem 1 / member count.

    Returns ``(ft_new [B, S], sq [T, B])`` in fresh tensors.
    """
    if g0p.device.type == "cpu":
        return sites_chunk_twin(g0p, g1p, ft, member_mask, site_weight,
                                limits, inv_counts, T, fast_math)
    if g0p.device.type != "cuda":
        raise ValueError(f"sites_chunk: no kernel for device {g0p.device}")
    b, p, s = g0p.shape
    dev = g0p.device
    for name, t, shape in (
        ("g0p", g0p, (b, p, s)), ("g1p", g1p, (b, p, s)), ("ft", ft, (b, s)),
        ("member_mask", member_mask, (b, p)),
        ("site_weight", site_weight, (b, s)), ("limits", limits, (b,)),
        ("inv_counts", inv_counts, (b,)),
    ):
        _kernels.check_operand(name, t, dev, _F32, shape)
    warps, smem = sites_chunk_geometry(p)
    n_tiles = -(-s // (32 * warps)) * warps  # one row of partials a warp
    aligned = _kernels.rows_aligned(s, g0p, g1p)
    ft_new = torch.empty_like(ft)
    sq_part = torch.empty((n_tiles, T, b), dtype=_F32, device=dev)
    _kernels.launch(
        "sites_chunk", dev, g0p.data_ptr(), g1p.data_ptr(), ft.data_ptr(),
        ft_new.data_ptr(), member_mask.data_ptr(), site_weight.data_ptr(),
        limits.data_ptr(), inv_counts.data_ptr(), sq_part.data_ptr(), b, p, s,
        T, warps, smem, int(aligned), int(bool(fast_math)),
    )
    sq = torch.sum(sq_part, dim=0, dtype=torch.float64).to(_F32)
    return ft_new, sq
