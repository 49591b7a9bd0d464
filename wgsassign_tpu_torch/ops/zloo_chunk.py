"""One chunk of T fused leave-one-out EM iterations of B z-score problems
of one population: the CUDA kernel (``csrc/zloo_chunk.cu``) and its plain
PyTorch twin.

Counterpart of ``zloo_chunk_pallas`` / ``_zloo_chunk_kernel`` in
``wgsassign_tpu/ops/pallas_emmaf.py``: problem b leaves out member
``leave[b]`` and takes ``min(T, limits[b])`` updates
``f_b <- clip(sum_{i != leave[b], i < n_real} w(g_i, f_b) / (n_real - 1))``
over the full site axis; its kept-site mask ``sw[b]`` enters only
``sq[t, b] = sum_s d * d * sw[b, s]``.  Rows of the member panel at or past
``n_real`` are padding.

:func:`zloo_chunk` launches the kernel for CUDA tensors and runs the twin
for CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import em_w
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS

_F32 = torch.float32

# Site tiles tried, largest first: the block stages an [n_real, S] tile of
# both GL panels in shared memory.
ZLOO_BLOCK_SITES = (128, 64, 32)


def _smem_bytes(n_real: int, b: int, t: int, block_sites: int) -> int:
    return 4 * (2 * n_real * block_sites + (block_sites // 32) * t * b)


def max_zloo_members(t: int, b: int) -> int:
    """Largest population (n_real members) whose member tile fits the
    smallest site tile beside the sq partials of ``b`` problems at chunk
    length ``t``: 900 at t = 8, b = 64."""
    s = ZLOO_BLOCK_SITES[-1]
    return (_kernels.SMEM_LIMIT // 4 - (s // 32) * t * b) // (2 * s)


def zloo_chunk_geometry(n_real: int, b: int, t: int) -> tuple:
    """``(block_sites, smem_bytes)``: the widest site tile whose member
    panel fits in shared memory.  Raises ValueError above the bound."""
    for s in ZLOO_BLOCK_SITES:
        smem = _smem_bytes(n_real, b, t, s)
        if smem <= _kernels.SMEM_LIMIT:
            return s, smem
    raise ValueError(
        f"zloo_chunk: a population of {n_real} members exceeds the kernel's "
        f"bound of {max_zloo_members(t, b)} members at chunk length {t} "
        f"and {b} problems (the member tile of {ZLOO_BLOCK_SITES[-1]} sites "
        f"must fit in {_kernels.SMEM_LIMIT} bytes of shared memory)"
    )


def zloo_chunk_twin(g0p, g1p, ft, sw, leave, limits, n_real: int, T: int,
                    fast_math: bool = True):
    """Plain PyTorch version of the chunk, same signature and result as
    :func:`zloo_chunk`.  Loops over members in ascending order, adding
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


def zloo_chunk(g0p, g1p, ft, sw, leave, limits, n_real: int, T: int,
               fast_math: bool = True):
    """T fused LOO-subset EM iterations for B problems of one population.

    Args:
      g0p, g1p: float32 ``[np_pad, M]`` member GL panels, site-minor;
        padded sites hold the (1, 0) GL pattern, rows >= ``n_real`` are
        padding.
      ft: float32 ``[B, M]`` per-problem AF.
      sw: float32 ``[B, M]`` per-problem kept-site masks (0 on padding).
      leave: int32 ``[B]`` member row each problem leaves out.
      limits: float32 ``[B]`` per-problem update limits (<= T).
      n_real: real member count (<= np_pad); the divisor is ``n_real - 1``.

    Returns ``(ft_new [B, M], sq [T, B])`` in fresh tensors.
    """
    if g0p.device.type == "cpu":
        return zloo_chunk_twin(g0p, g1p, ft, sw, leave, limits, n_real, T,
                               fast_math)
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
    block_sites, smem = zloo_chunk_geometry(n_real, b, T)
    n_blocks = -(-m // block_sites)
    ft_new = torch.empty_like(ft)
    sq_part = torch.empty((n_blocks, T, b), dtype=_F32, device=dev)
    _kernels.launch(
        "zloo_chunk", dev, g0p.data_ptr(), g1p.data_ptr(), ft.data_ptr(),
        ft_new.data_ptr(), sw.data_ptr(), leave.data_ptr(),
        limits.data_ptr(), sq_part.data_ptr(), b, m, n_real, T, block_sites,
        smem, int(bool(fast_math)),
    )
    sq = torch.sum(sq_part, dim=0, dtype=torch.float64).to(_F32)
    return ft_new, sq
