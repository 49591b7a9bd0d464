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
    max_zloo_members,
    zloo_chunk,
    zloo_chunk_geometry,
    zloo_chunk_twin,
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
    f, sq = zloo_chunk(*map(torch.from_numpy, (g0p, g1p, ft, sw, leave, lim)),
                       N_REAL, T, fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref)[:, 0, :], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    for b in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[b], ft[b])


def test_wrapper_runs_twin_on_cpu_and_keeps_input():
    g0p, g1p, ft, sw, leave = _zloo_inputs(m=40)
    args = [torch.from_numpy(a) for a in
            (g0p, g1p, ft, sw, leave, np.full(B, 3, np.float32))]
    ft_before = args[2].clone()
    before = _kernels.launches["zloo_chunk"]
    f_w, sq_w = zloo_chunk(*args, N_REAL, 3)
    f_t, sq_t = zloo_chunk_twin(*args, N_REAL, 3)
    torch.testing.assert_close(f_w, f_t, rtol=0, atol=0)
    torch.testing.assert_close(sq_w, sq_t, rtol=0, atol=0)
    torch.testing.assert_close(args[2], ft_before, rtol=0, atol=0)
    assert _kernels.launches["zloo_chunk"] == before


@pytest.mark.parametrize("n_real,b,block_sites", [
    (36, 13, 128),   # one population's share of a 64-individual group
    (300, 64, 64),
    (800, 64, 32),
])
def test_geometry_picks_widest_tile(n_real, b, block_sites):
    s, smem = zloo_chunk_geometry(n_real, b, 8)
    assert s == block_sites
    assert smem <= _kernels.SMEM_LIMIT


def test_member_bound_raises():
    bound = max_zloo_members(8, 64)
    assert bound == 900
    zloo_chunk_geometry(bound, 64, 8)
    with pytest.raises(ValueError, match="900 members"):
        zloo_chunk_geometry(bound + 1, 64, 8)
