"""One chunk of T fused all-population EM iterations: the CUDA kernel
(``csrc/em_chunk.cu``) and its plain PyTorch twin.

Counterpart of ``em_chunk_pallas`` / ``_em_chunk_kernel`` in
``wgsassign_tpu/ops/pallas_emmaf.py``, with the same chunk contract: the AF
panel crosses the call as ``ft [K, M]``, population k takes
``min(T, limits[k])`` updates, and ``sq[t, k]`` is the squared update of
iteration t summed over the sites.  An int32 individual -> population index
replaces the one-hot membership (the gather is exact either way).

:func:`em_chunk` launches the kernel for CUDA tensors and runs the twin for
CPU tensors; nothing else chooses between them.
"""

from __future__ import annotations

import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS

_F32 = torch.float32

# The kernel's tile (csrc/em_chunk.cu): EM_LANES threads share a site, lane l
# summing members l, l + EM_LANES, ... of each population (in ascending
# individual order) before a butterfly combines the lanes; a block owns the
# largest of EM_BLOCK_SITES consecutive sites whose GLs fit in shared memory.
EM_LANES = 8
EM_BLOCK_SITES = (16, 8, 4)
# When even 4 sites of all N individuals do not fit, a population's members
# are walked in slices through a tile of this many bytes at most.
EM_SLICED_TILE_BYTES = _kernels.SMEM_LIMIT // 4


def em_w(g0, g1, g2, f, fast_math: bool):
    """The EM weight ``(p1 + 2 p2) / (2 (p0 + p1 + p2))`` in the JAX
    package's two op orders (``pallas_emmaf.py::_em_w``): the canonical form
    and the reduced DEFAULT ``(u + p2) / (p0 + 2u + p2)`` with ``u = p1/2``.
    The reduction scales operands by powers of two only, so the two round
    identically for normal-range operands.  The kernels evaluate the same
    expressions op for op (``csrc/common.cuh``)."""
    omf = 1.0 - f
    if fast_math:
        u = g1 * f * omf
        p0 = g0 * omf * omf
        p2 = g2 * f * f
        return (u + p2) / (p0 + 2.0 * u + p2)
    p0 = g0 * omf * omf
    p1 = g1 * 2.0 * f * omf
    p2 = g2 * f * f
    return (p1 + 2.0 * p2) / (2.0 * (p0 + p1 + p2))


def _tile_stride(width: int) -> int:
    """Row stride of the shared tile in (g0, g1) pairs: the smallest
    ``>= width`` that is 8 mod 16, so the two sites of a half-warp's 8-byte
    loads fall into disjoint banks."""
    return width + (8 - width) % 16


def em_chunk_geometry(n: int, k: int, t: int) -> tuple:
    """``(block_sites, stride, nc, smem_bytes)`` for the kernel.  ``nc == n``:
    the block's GLs stay resident in shared memory for all T iterations, at
    the largest of EM_BLOCK_SITES that fits.  Otherwise (n above ~7,000) a
    block of 4 sites walks each population's members in slices of ``nc``
    positions, so there is no bound on the number of individuals."""
    def fixed(s):  # the population table, f and the per-warp sq partials
        return 16 * k + 4 * (k * s + (s * EM_LANES // 32) * t * k)

    stride = _tile_stride(n)
    for s in EM_BLOCK_SITES:
        smem = 8 * s * stride + fixed(s)
        if smem <= _kernels.SMEM_LIMIT:
            return s, stride, n, smem
    s = EM_BLOCK_SITES[-1]
    room = (EM_SLICED_TILE_BYTES - fixed(s)) // (8 * s)
    nc = room - (room - 8) % 16  # the largest <= room that is 8 mod 16
    if nc < EM_LANES:
        raise ValueError(
            f"em_chunk: K={k} populations x T={t} iterations leave no shared "
            "memory for the GL tile; use a shorter chunk"
        )
    return s, nc, nc, 8 * s * nc + fixed(s)


def _population_order(pop_index, k: int):
    """``(order, pos, beg)``, int32 ``[N]``, ``[N]``, ``[K + 1]``: the
    individuals in population order (a stable sort, so ascending within a
    population), each individual's position in that order, and each
    population's range of positions."""
    pops = pop_index.long()
    order = torch.argsort(pops, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    beg = torch.searchsorted(
        pops[order], torch.arange(k + 1, device=order.device))
    return order.to(torch.int32), pos.to(torch.int32), beg.to(torch.int32)


def em_chunk_twin(g0, g1, ft, pop_index, inv_counts, limits, T: int,
                  fast_math: bool = True):
    """Plain PyTorch version of the chunk, same signature and result as
    :func:`em_chunk`.  It sums in the kernel's order: member number r of a
    population (ascending individual order) goes to lane ``r % EM_LANES``,
    each lane adds its members in ascending order, and the lanes are
    combined by the butterfly xor 4, 2, 1."""
    k, m = ft.shape
    g2 = 1.0 - g0 - g1
    pops = pop_index.tolist()
    lims = limits.tolist()
    idx = pop_index.long()
    lanes = torch.arange(EM_LANES, device=ft.device)
    f = ft.clone()
    sq = torch.empty((T, k), dtype=_F32, device=ft.device)
    for t in range(T):
        w = em_w(g0, g1, g2, f[idx].t(), fast_math)  # [M, N]
        acc = torch.zeros((EM_LANES, k, m), dtype=_F32, device=ft.device)
        seen = [0] * k
        for i, kk in enumerate(pops):
            if lims[kk] > t:
                acc[seen[kk] % EM_LANES, kk] += w[:, i]
            seen[kk] += 1
        off = EM_LANES // 2
        while off:
            acc = acc + acc[lanes ^ off]
            off //= 2
        f_upd = torch.clamp(acc[0] * inv_counts[:, None], _EM_EPS,
                            1.0 - _EM_EPS)
        f_new = torch.where(limits[:, None] > t, f_upd, f)
        d = f_new - f
        sq[t] = torch.sum(d * d, dim=1)
        f = f_new
    return f, sq


def em_chunk(g0, g1, ft, pop_index, inv_counts, limits, T: int,
             fast_math: bool = True):
    """T fused EM iterations for all K populations.

    Args:
      g0, g1: float32 ``[M, N]``; padded rows hold the (1, 0) GL pattern and
        their ``ft`` entries ``_EM_EPS`` (their fixed point).
      ft: float32 ``[K, M]`` current AF panel.
      pop_index: int32 ``[N]`` population of each individual.
      inv_counts: float32 ``[K]`` 1 / population size.
      limits: float32 ``[K]`` per-population update limits (<= T).

    Returns ``(ft_new [K, M], sq [T, K])`` in fresh tensors (``ft`` is never
    written, so a caller may keep it as a replay snapshot).
    """
    if g0.device.type == "cpu":
        return em_chunk_twin(g0, g1, ft, pop_index, inv_counts, limits, T,
                             fast_math)
    if g0.device.type != "cuda":
        raise ValueError(f"em_chunk: no kernel for device {g0.device}")
    m, n = g0.shape
    k = ft.shape[0]
    dev = g0.device
    for name, t, dtype, shape in (
        ("g0", g0, _F32, (m, n)), ("g1", g1, _F32, (m, n)),
        ("ft", ft, _F32, (k, m)), ("pop_index", pop_index, torch.int32, (n,)),
        ("inv_counts", inv_counts, _F32, (k,)), ("limits", limits, _F32, (k,)),
    ):
        _kernels.check_operand(name, t, dev, dtype, shape)
    block_sites, stride, nc, smem = em_chunk_geometry(n, k, T)
    order, pos, beg = _population_order(pop_index, k)
    n_blocks = -(-m // block_sites)
    ft_new = torch.empty_like(ft)
    sq_part = torch.empty((n_blocks, T, k), dtype=_F32, device=dev)
    _kernels.launch(
        "em_chunk", dev, g0.data_ptr(), g1.data_ptr(), ft.data_ptr(),
        ft_new.data_ptr(), pop_index.data_ptr(), pos.data_ptr(),
        order.data_ptr(), beg.data_ptr(),
        inv_counts.data_ptr(), limits.data_ptr(), sq_part.data_ptr(), m, n,
        k, T, block_sites, stride, nc, smem, int(bool(fast_math)),
    )
    # the block partials are summed in one fixed order (no atomics): the
    # convergence decision reads them
    sq = torch.sum(sq_part, dim=0, dtype=torch.float64).to(_F32)
    return ft_new, sq
