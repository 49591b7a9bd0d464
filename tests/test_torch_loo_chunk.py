"""The port's LOO chunk (``wgsassign_tpu_torch.ops.loo_chunk``) against the
JAX package's Pallas LOO chunk kernel, run in interpret mode on the CPU.

Tolerances as in test_torch_em_chunk.py: ``ft`` atol 2e-6, ``sq`` rtol
1e-5 (member sums in another order than the Pallas reduction)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from wgsassign_tpu.ops.pallas_emmaf import loo_chunk_pallas
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.loo_chunk import (
    LOO_MAX_WARPS,
    LOO_PROBLEM_TILE,
    LOO_SITES,
    loo_chunk_geometry,
    loo_chunk_twin,
    loo_step,
    max_loo_members,
)


def _loo_inputs(n_real=5, np_pad=8, m=256, seed=3):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(np_pad, m)).astype(np.float32)
    g0p, g1p = raw[:, :, 0].copy(), raw[:, :, 1].copy()
    g0p[n_real:], g1p[n_real:] = 1.0, 0.0  # padded member rows
    ft = rng.uniform(0.05, 0.95, size=(np_pad, m)).astype(np.float32)
    return g0p, g1p, ft


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("limits", [
    [4, 4, 4, 4, 4, 0, 0, 0],   # padded problem rows take no update
    [4, 1, 0, 3, 4, 0, 0, 0],   # mixed per-problem limits (a replay)
])
def test_twin_matches_pallas_chunk(fast_math, limits):
    T, n_real = 4, 5
    g0p, g1p, ft = _loo_inputs()
    lim = np.asarray(limits, np.float32)
    f_ref, sq_ref = loo_chunk_pallas(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(ft),
        jnp.asarray(lim.reshape(1, -1)), n_real, T, interpret=True,
        fast_math=fast_math,
    )
    f, sq = loo_chunk_twin(*map(torch.from_numpy, (g0p, g1p, ft, lim)),
                           n_real, T, fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    for j in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[j], ft[j])


def test_wrapper_runs_twin_on_cpu_and_keeps_input():
    """On the CPU ``loo_step`` runs the twin's one iteration (no launch) and
    writes it in place; the twin leaves its own input as it was, and a
    stopped problem's row keeps its value."""
    g0p, g1p, ft = _loo_inputs(n_real=6, np_pad=6, m=40)
    lim = np.ones(6, np.float32)
    lim[4] = 0.0
    args = [torch.from_numpy(a) for a in (g0p, g1p, ft, lim)]
    ft_before = args[2].clone()
    f_t, sq_t = loo_chunk_twin(*args, 6, 1)
    torch.testing.assert_close(args[2], ft_before, rtol=0, atol=0)
    before = _kernels.launches["loo_chunk"]
    ft_w = args[2].clone()
    sq_w = loo_step(args[0], args[1], ft_w, args[3], 6)
    torch.testing.assert_close(ft_w, f_t, rtol=0, atol=0)
    torch.testing.assert_close(sq_w, sq_t, rtol=0, atol=0)
    torch.testing.assert_close(ft_w[4], ft_before[4], rtol=0, atol=0)
    assert _kernels.launches["loo_chunk"] == before


@pytest.mark.parametrize("n_real,np_pad,m,limits", [
    # n_real one over and one under a multiple of 32 and of the problem
    # tile; limits of 0 and mixed; M off the 32-site tile and off 4
    (33, 40, 70, "all"), (31, 32, 70, "mixed"), (5, 8, 257, "mixed"),
    (3, 8, 33, "all"), (2, 8, 64, "all"), (9, 16, 30, "zero"),
])
@pytest.mark.parametrize("fast_math", [True, False])
def test_twin_matches_pallas_chunk_shapes(n_real, np_pad, m, limits,
                                          fast_math):
    T = 3
    g0p, g1p, ft = _loo_inputs(n_real, np_pad, m, seed=5)
    lim = np.zeros(np_pad, np.float32)
    if limits == "all":
        lim[:n_real] = T
    elif limits == "mixed":
        lim[:n_real] = np.arange(n_real) % (T + 1)
    f_ref, sq_ref = loo_chunk_pallas(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(ft),
        jnp.asarray(lim.reshape(1, -1)), n_real, T, interpret=True,
        fast_math=fast_math,
    )
    f, sq = loo_chunk_twin(*map(torch.from_numpy, (g0p, g1p, ft, lim)),
                           n_real, T, fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=1e-12)
    for j in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[j], ft[j])
        assert not sq.numpy()[:, j].any()


@pytest.mark.parametrize("n_p,warps", [
    (36, 3),     # the headline population size: 9 tiles, three rounds each
    (40, 2),     # 10 tiles over 2 warps
    (300, 8),    # a large tile: as many warps as a block may have
    (5, 1),      # two tiles of a small population
])
def test_geometry_picks_widest_tile(n_p, warps):
    """The block's tile is [n_p, LOO_SITES] whatever the chunk length; the
    warp count leaves no warp idle where it can."""
    w, smem = loo_chunk_geometry(n_p)
    assert w == warps and 1 <= w <= LOO_MAX_WARPS
    assert smem == 4 * 2 * n_p * LOO_SITES <= _kernels.SMEM_LIMIT
    tiles = -(-n_p // LOO_PROBLEM_TILE)
    assert -(-tiles // w) * w - tiles < w


def test_member_bound_raises():
    """The member bound is where staging ends, and nothing raises there any
    more: up to 908 members the tile is staged in shared memory; above, the
    geometry asks for the kernel's unstaged form (no shared memory)."""
    bound = max_loo_members()
    assert bound == 908
    assert 0 < loo_chunk_geometry(bound)[1] <= _kernels.SMEM_LIMIT
    for n_p in (bound + 1, 2000, 20000):
        assert loo_chunk_geometry(n_p) == (LOO_MAX_WARPS, 0)
