"""The port's EM chunk (``wgsassign_tpu_torch.ops.em_chunk``) against the JAX
package's Pallas chunk kernel, run in interpret mode on the CPU.

Tolerances: ``ft`` atol 2e-6 (the member sums run in another order than
the Pallas one-hot reduction, a few float32 ulps after T iterations), ``sq``
rtol 1e-5 (sums of squared updates, same reason)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from wgsassign_tpu.ops.pallas_emmaf import em_chunk_pallas
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import (
    EM_BLOCK_SITES,
    em_chunk,
    em_chunk_geometry,
    em_chunk_twin,
)


def _chunk_inputs(m=256, n=24, k=3, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    g0, g1 = raw[:, :, 0].copy(), raw[:, :, 1].copy()
    pop_index = (np.arange(n) % k).astype(np.int32)
    onehot = np.zeros((k, n), np.float32)
    onehot[pop_index, np.arange(n)] = 1.0
    ft = rng.uniform(0.05, 0.95, size=(k, m)).astype(np.float32)
    inv_counts = (1.0 / onehot.sum(axis=1)).astype(np.float32)
    return g0, g1, ft, pop_index, onehot, inv_counts


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("limits", [[5.0, 5.0, 5.0], [5.0, 2.0, 0.0]])
def test_twin_matches_pallas_chunk(fast_math, limits):
    T = 5
    g0, g1, ft, pop_index, onehot, inv_counts = _chunk_inputs()
    lim = np.asarray(limits, np.float32)
    f_ref, sq_ref = em_chunk_pallas(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(ft),
        jnp.asarray(onehot), tuple(float(x) for x in inv_counts),
        jnp.asarray(lim.reshape(1, -1)), T, interpret=True,
        fast_math=fast_math,
    )
    f, sq = em_chunk(
        *map(torch.from_numpy, (g0, g1, ft, pop_index, inv_counts, lim)),
        T, fast_math=fast_math,
    )
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    # a population past its limit keeps its AF exactly
    for kk in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[kk], ft[kk])
        assert not sq.numpy()[:, kk].any()


def test_wrapper_runs_twin_on_cpu_and_keeps_input():
    g0, g1, ft, pop_index, _, inv_counts = _chunk_inputs(m=64, n=9)
    args = [torch.from_numpy(a) for a in
            (g0, g1, ft, pop_index, inv_counts, np.full(3, 4, np.float32))]
    ft_before = args[2].clone()
    before = _kernels.launches["em_chunk"]
    f_w, sq_w = em_chunk(*args, 4)
    f_t, sq_t = em_chunk_twin(*args, 4)
    torch.testing.assert_close(f_w, f_t, rtol=0, atol=0)
    torch.testing.assert_close(sq_w, sq_t, rtol=0, atol=0)
    # the replay snapshot contract: the chunk never writes its input
    torch.testing.assert_close(args[2], ft_before, rtol=0, atol=0)
    assert _kernels.launches["em_chunk"] == before


def test_padded_sites_add_nothing():
    """Rows holding the (1, 0) pattern at f = EPS stay there and add 0."""
    g0, g1, ft, pop_index, _, inv_counts = _chunk_inputs(m=64, n=12)
    g0[32:], g1[32:] = 1.0, 0.0
    ft[:, 32:] = np.float32(1e-7)
    f, sq = em_chunk(
        *map(torch.from_numpy, (g0, g1, ft, pop_index, inv_counts,
                                np.full(3, 6, np.float32))), 6)
    np.testing.assert_array_equal(f.numpy()[:, 32:], ft[:, 32:])
    _, sq_real = em_chunk(
        *map(torch.from_numpy, (g0[:32], g1[:32], ft[:, :32].copy(),
                                pop_index, inv_counts,
                                np.full(3, 6, np.float32))), 6)
    np.testing.assert_allclose(sq.numpy(), sq_real.numpy(), rtol=1e-6)


@pytest.mark.parametrize("n,k,t,resident", [
    (180, 5, 16, True),    # the headline cohort width: the tile stays resident
    (24, 3, 5, True),
    (5000, 5, 16, False),  # wider than shared memory: staged per iteration
])
def test_geometry(n, k, t, resident):
    nc, smem = em_chunk_geometry(n, k, t)
    assert (nc == n) == resident
    assert 1 <= nc <= n
    assert smem <= _kernels.SMEM_LIMIT
    assert smem == 4 * (2 * nc * (EM_BLOCK_SITES + 1)
                        + 2 * k * EM_BLOCK_SITES
                        + (EM_BLOCK_SITES // 32) * t * k)

