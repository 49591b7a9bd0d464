"""The port's z-score LOO chunk (``wgsassign_tpu_torch.ops.zloo_chunk``)
against the JAX package's Pallas zLOO chunk kernel, run in interpret mode
on the CPU.

Tolerances: ``ft`` atol 2e-6, ``sq`` rtol 1e-5 (member sums in another
order than the Pallas reduction), as test_torch_loo_chunk.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from wgsassign_tpu.ops.pallas_emmaf import zloo_chunk_pallas
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.zloo_chunk import (
    ZLOO_MAX_WARPS,
    max_zloo_members,
    zloo_chunk_geometry,
    zloo_chunk_twin,
    zloo_step,
)

N_REAL, NP_PAD, B, M, T = 5, 8, 3, 256, 4


def _zloo_inputs(n_real=N_REAL, np_pad=NP_PAD, b=B, m=M, seed=5):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(np_pad, m)).astype(np.float32)
    g0p, g1p = raw[:, :, 0].copy(), raw[:, :, 1].copy()
    g0p[n_real:], g1p[n_real:] = 1.0, 0.0  # padded member rows
    ft = rng.uniform(0.05, 0.95, size=(b, m)).astype(np.float32)
    sw = (rng.random((b, m)) < 0.7).astype(np.float32)
    leave = rng.choice(n_real, size=b, replace=False).astype(np.int32)
    return g0p, g1p, ft, sw, leave


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("limits", [
    [4, 4, 4],   # every problem runs the whole chunk
    [4, 1, 0],   # mixed per-problem limits (a replay)
])
def test_twin_matches_pallas_chunk(fast_math, limits):
    g0p, g1p, ft, sw, leave = _zloo_inputs()
    lim = np.asarray(limits, np.float32)
    f_ref, sq_ref = zloo_chunk_pallas(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(ft[:, None, :]),
        jnp.asarray(sw[:, None, :]), jnp.asarray(leave.reshape(B, 1, 1)),
        jnp.asarray(lim.reshape(B, 1, 1)), N_REAL, T, interpret=True,
        fast_math=fast_math,
    )
    f, sq = zloo_chunk_twin(
        *map(torch.from_numpy, (g0p, g1p, ft, sw, leave, lim)), N_REAL, T,
        fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref)[:, 0, :], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    for b in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[b], ft[b])


def test_wrapper_runs_twin_on_cpu_and_keeps_input():
    """On the CPU ``zloo_step`` runs the twin's one iteration (no launch)
    and writes it in place; the twin leaves its own input as it was, and a
    stopped problem's row keeps its value."""
    g0p, g1p, ft, sw, leave = _zloo_inputs(m=40)
    lim = np.ones(B, np.float32)
    lim[1] = 0.0
    args = [torch.from_numpy(a) for a in (g0p, g1p, ft, sw, leave, lim)]
    ft_before = args[2].clone()
    f_t, sq_t = zloo_chunk_twin(*args, N_REAL, 1)
    torch.testing.assert_close(args[2], ft_before, rtol=0, atol=0)
    before = _kernels.launches["zloo_chunk"]
    ft_w = args[2].clone()
    sq_w = zloo_step(args[0], args[1], ft_w, *args[3:], N_REAL)
    torch.testing.assert_close(ft_w, f_t, rtol=0, atol=0)
    torch.testing.assert_close(sq_w, sq_t, rtol=0, atol=0)
    torch.testing.assert_close(ft_w[1], ft_before[1], rtol=0, atol=0)
    assert _kernels.launches["zloo_chunk"] == before


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("leave,limits", [
    ([2, 2, 2], [4, 4, 4]),            # repeated left-out member
    ([4, 2, 0], [4, 3, 4]),            # descending
    ([3], [4]),                        # B = 1
    ([0, 4, 1, 1, 3], [4, 0, 2, 4, 1]),  # B = 5: a full tile and one more
])
def test_twin_matches_pallas_chunk_leave_patterns(fast_math, leave, limits):
    """What the CUDA kernel special-cases (the split of the member loop at
    the tile's left-out rows, ragged problem tiles, the order by limit) is
    plain in the twin: it must agree with the Pallas kernel on them."""
    b = len(leave)
    g0p, g1p, ft, sw, _ = _zloo_inputs(b=b, seed=6)
    lv = np.asarray(leave, np.int32)
    lim = np.asarray(limits, np.float32)
    f_ref, sq_ref = zloo_chunk_pallas(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(ft[:, None, :]),
        jnp.asarray(sw[:, None, :]), jnp.asarray(lv.reshape(b, 1, 1)),
        jnp.asarray(lim.reshape(b, 1, 1)), N_REAL, T, interpret=True,
        fast_math=fast_math,
    )
    f, sq = zloo_chunk_twin(
        *map(torch.from_numpy, (g0p, g1p, ft, sw, lv, lim)), N_REAL, T,
        fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref)[:, 0, :], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    for i in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[i], ft[i])
        np.testing.assert_array_equal(sq.numpy()[:, i], 0.0)


@pytest.mark.parametrize("n_real,b,warps", [
    (36, 13, 3),   # one population's share of a 64-individual group: 5, 4, 4
    (36, 12, 3),   # three full tiles, one a warp
    (36, 64, 2),   # 16 tiles over 2 warps: shared memory allows 22 blocks
    (36, 1, 1),
    (36, 5, 1),    # a second warp would idle three quarters of the time
    (300, 64, 8),  # 76.8 KB a block: 2 blocks an SM, so the most warps
])
def test_geometry_picks_warps(n_real, b, warps):
    w, smem = zloo_chunk_geometry(n_real, b)
    assert w == warps
    assert smem == 8 * n_real * 32 <= _kernels.SMEM_LIMIT


def test_member_bound_raises():
    bound = max_zloo_members()
    assert bound == 908
    for b in (1, 64, 500):  # the bound depends on neither B nor T
        assert 0 < zloo_chunk_geometry(bound, b)[1] <= _kernels.SMEM_LIMIT
        # nothing raises above it any more: the geometry asks for the
        # kernel's unstaged form (no shared memory)
        for n_p in (bound + 1, 5000):
            warps, smem = zloo_chunk_geometry(n_p, b)
            assert smem == 0 and 1 <= warps <= ZLOO_MAX_WARPS
