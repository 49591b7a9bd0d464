"""One chunk of T fused leave-one-out EM iterations for one population: the
CUDA kernel (``csrc/loo_chunk.cu``) and its plain PyTorch twin.

Counterpart of ``loo_chunk_pallas`` / ``_loo_chunk_kernel`` in
``wgsassign_tpu/ops/pallas_emmaf.py``: problem j (member j left out) takes
``min(T, limits[j])`` updates
``f_j <- clip(sum_{i != j, i < n_real} w(g_i, f_j) / (n_real - 1))``, and
``sq[t, j]`` is its squared update of iteration t summed over the sites.
``n_real`` is a run-time value; rows at or past it are padding.

:func:`loo_chunk` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import em_w
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS

_F32 = torch.float32

# Site tiles tried, largest first: the block stages an [n_real, S] tile of
# both GL panels in shared memory.
LOO_BLOCK_SITES = (128, 64, 32)


def _smem_bytes(n_real: int, p: int, t: int, block_sites: int) -> int:
    return 4 * (2 * n_real * block_sites + (block_sites // 32) * t * p)


def max_loo_members(t: int) -> int:
    """Largest population (P = n_real members) whose member tile fits the
    smallest site tile at chunk length ``t``: 807 at t = 8."""
    s = LOO_BLOCK_SITES[-1]
    return _kernels.SMEM_LIMIT // (4 * (2 * s + (s // 32) * t))


def loo_chunk_geometry(n_real: int, p: int, t: int) -> tuple:
    """``(block_sites, smem_bytes)``: the widest site tile whose member
    panel fits in shared memory.  Raises ValueError above the bound."""
    for s in LOO_BLOCK_SITES:
        smem = _smem_bytes(n_real, p, t, s)
        if smem <= _kernels.SMEM_LIMIT:
            return s, smem
    raise ValueError(
        f"loo_chunk: a population of {n_real} members exceeds the kernel's "
        f"bound of {max_loo_members(t)} members at chunk length {t} (the "
        f"member tile of {LOO_BLOCK_SITES[-1]} sites must fit in "
        f"{_kernels.SMEM_LIMIT} bytes of shared memory)"
    )


def loo_chunk_twin(g0p, g1p, ft, limits, n_real: int, T: int,
                   fast_math: bool = True):
    """Plain PyTorch version of the chunk, same signature and result as
    :func:`loo_chunk`.  Loops over members in ascending order, adding member
    i's weights under every problem's AF with problem i masked out, so no
    ``[P, P, M]`` tensor is built."""
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


def loo_chunk(g0p, g1p, ft, limits, n_real: int, T: int,
              fast_math: bool = True):
    """T fused LOO EM iterations for one population.

    Args:
      g0p, g1p: float32 ``[P, M]`` member GL panels, site-minor; padded
        sites hold the (1, 0) GL pattern.
      ft: float32 ``[P, M]`` per-problem AF (padded sites at ``_EM_EPS``).
      limits: float32 ``[P]`` per-problem update limits (<= T; 0 for
        padded problem rows).
      n_real: real member count (<= P); the divisor is ``n_real - 1``.

    Returns ``(ft_new [P, M], sq [T, P])`` in fresh tensors.
    """
    if g0p.device.type == "cpu":
        return loo_chunk_twin(g0p, g1p, ft, limits, n_real, T, fast_math)
    if g0p.device.type != "cuda":
        raise ValueError(f"loo_chunk: no kernel for device {g0p.device}")
    p, m = ft.shape
    dev = g0p.device
    if not 2 <= n_real <= p:
        raise ValueError(f"loo_chunk: n_real={n_real} outside [2, {p}]")
    for name, t, shape in (("g0p", g0p, (p, m)), ("g1p", g1p, (p, m)),
                           ("ft", ft, (p, m)), ("limits", limits, (p,))):
        _kernels.check_operand(name, t, dev, _F32, shape)
    block_sites, smem = loo_chunk_geometry(n_real, p, T)
    n_blocks = -(-m // block_sites)
    ft_new = torch.empty_like(ft)
    sq_part = torch.empty((n_blocks, T, p), dtype=_F32, device=dev)
    _kernels.launch(
        "loo_chunk", dev, g0p.data_ptr(), g1p.data_ptr(), ft.data_ptr(),
        ft_new.data_ptr(), limits.data_ptr(), sq_part.data_ptr(), p, m,
        n_real, T, block_sites, smem, int(bool(fast_math)),
    )
    sq = torch.sum(sq_part, dim=0, dtype=torch.float64).to(_F32)
    return ft_new, sq
