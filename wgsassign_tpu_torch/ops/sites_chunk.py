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

# Site tiles tried, largest first: the block stages a [P, S] slice of both
# of its problem's panels in shared memory.
SITES_BLOCK_SITES = (128, 64, 32)


def _smem_bytes(p: int, t: int, block_sites: int) -> int:
    return 4 * (2 * p * block_sites + (block_sites // 32) * t)


def max_sites_members(t: int) -> int:
    """Largest member panel (P rows) whose slice fits the smallest site
    tile at chunk length ``t``: 907 at t = 8."""
    s = SITES_BLOCK_SITES[-1]
    return (_kernels.SMEM_LIMIT // 4 - (s // 32) * t) // (2 * s)


def sites_chunk_geometry(p: int, t: int) -> tuple:
    """``(block_sites, smem_bytes)``: the widest site tile whose panel
    slice fits in shared memory.  Raises ValueError above the bound."""
    for s in SITES_BLOCK_SITES:
        smem = _smem_bytes(p, t, s)
        if smem <= _kernels.SMEM_LIMIT:
            return s, smem
    raise ValueError(
        f"sites_chunk: a member panel of {p} rows exceeds the kernel's bound "
        f"of {max_sites_members(t)} members at chunk length {t} (the panel "
        f"slice of {SITES_BLOCK_SITES[-1]} sites must fit in "
        f"{_kernels.SMEM_LIMIT} bytes of shared memory)"
    )


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
    block_sites, smem = sites_chunk_geometry(p, T)
    n_blocks = -(-s // block_sites)
    ft_new = torch.empty_like(ft)
    sq_part = torch.empty((n_blocks, T, b), dtype=_F32, device=dev)
    _kernels.launch(
        "sites_chunk", dev, g0p.data_ptr(), g1p.data_ptr(), ft.data_ptr(),
        ft_new.data_ptr(), member_mask.data_ptr(), site_weight.data_ptr(),
        limits.data_ptr(), inv_counts.data_ptr(), sq_part.data_ptr(), b, p, s,
        T, block_sites, smem, int(bool(fast_math)),
    )
    sq = torch.sum(sq_part, dim=0, dtype=torch.float64).to(_F32)
    return ft_new, sq
