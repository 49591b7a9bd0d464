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
    loo_chunk,
    loo_chunk_geometry,
    loo_chunk_twin,
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
    f, sq = loo_chunk(*map(torch.from_numpy, (g0p, g1p, ft, lim)), n_real, T,
                      fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    for j in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[j], ft[j])


def test_wrapper_runs_twin_on_cpu_and_keeps_input():
    g0p, g1p, ft = _loo_inputs(n_real=6, np_pad=6, m=40)
    args = [torch.from_numpy(a) for a in
            (g0p, g1p, ft, np.full(6, 3, np.float32))]
    ft_before = args[2].clone()
    before = _kernels.launches["loo_chunk"]
    f_w, sq_w = loo_chunk(*args, 6, 3)
    f_t, sq_t = loo_chunk_twin(*args, 6, 3)
    torch.testing.assert_close(f_w, f_t, rtol=0, atol=0)
    torch.testing.assert_close(sq_w, sq_t, rtol=0, atol=0)
    torch.testing.assert_close(args[2], ft_before, rtol=0, atol=0)
    assert _kernels.launches["loo_chunk"] == before


@pytest.mark.parametrize("n_p,t,block_sites", [
    (36, 8, 128),    # the headline population size
    (300, 8, 64),
    (700, 8, 32),
])
def test_geometry_picks_widest_tile(n_p, t, block_sites):
    s, smem = loo_chunk_geometry(n_p, n_p, t)
    assert s == block_sites
    assert smem <= _kernels.SMEM_LIMIT


def test_member_bound_raises():
    bound = max_loo_members(8)
    assert bound == 807
    loo_chunk_geometry(bound, bound, 8)
    with pytest.raises(ValueError, match="807 members"):
        loo_chunk_geometry(bound + 1, bound + 1, 8)

