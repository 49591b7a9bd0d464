"""The port's EM chunk (``wgsassign_tpu_torch.ops.em_chunk``) against the JAX
package's Pallas chunk kernel, run in interpret mode on the CPU.

Tolerances: ``ft`` atol 2e-6 (the member sums run in another order than
the Pallas one-hot reduction -- lane-strided partial sums and a butterfly,
the CUDA kernel's order -- a few float32 ulps after T iterations), ``sq``
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
    EM_LANES,
    _population_order,
    em_chunk,
    em_chunk_geometry,
    em_chunk_twin,
)
from wgsassign_tpu_torch.ops.emmaf import _EM_EPS


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


@pytest.mark.parametrize("m,n,k,limits", [
    # N one over and one under a multiple of 32 and of the 8 lanes; one
    # population and eight; limits of 0 and mixed; M off the 16-site tile
    (72, 33, 3, [4, 4, 4]), (72, 31, 3, [4, 2, 0]),
    (50, 9, 1, [4]), (50, 7, 1, [3]), (50, 8, 1, [0]),
    (100, 65, 8, [4, 0, 1, 4, 2, 0, 3, 4]), (17, 41, 8, [4] * 8),
    (130, 24, 2, [0, 0]),
])
@pytest.mark.parametrize("fast_math", [True, False])
def test_twin_matches_pallas_chunk_shapes(m, n, k, limits, fast_math):
    T = 4
    g0, g1, ft, pop_index, onehot, inv_counts = _chunk_inputs(m, n, k, seed=7)
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
                               atol=1e-12)
    for kk in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[kk], ft[kk])
        assert not sq.numpy()[:, kk].any()


@pytest.mark.parametrize("n,k", [(33, 3), (7, 1), (65, 8), (180, 5)])
def test_twin_sums_in_the_kernels_order(n, k):
    """One iteration of the twin equals the sum written out: member r of a
    population on lane r % EM_LANES, lanes combined by xor 4, 2, 1."""
    m = 24
    g0, g1, ft, pop_index, _, inv_counts = _chunk_inputs(m, n, k, seed=9)
    pop_index = np.random.default_rng(1).permutation(pop_index)
    inv_counts = (1.0 / np.bincount(pop_index, minlength=k)).astype(
        np.float32)
    lim = np.ones(k, np.float32)
    f, _ = em_chunk_twin(
        *map(torch.from_numpy, (g0, g1, ft, pop_index, inv_counts, lim)), 1)
    from wgsassign_tpu_torch.ops.em_chunk import em_w

    g0t, g1t = torch.from_numpy(g0), torch.from_numpy(g1)
    want = np.empty((k, m), np.float32)
    for kk in range(k):
        fk = torch.from_numpy(ft[kk])
        lanes = [torch.zeros(m) for _ in range(EM_LANES)]
        for r, i in enumerate(np.flatnonzero(pop_index == kk)):
            a, b = g0t[:, i], g1t[:, i]
            lanes[r % EM_LANES] = lanes[r % EM_LANES] + em_w(
                a, b, 1.0 - a - b, fk, True)
        off = EM_LANES // 2
        while off:
            lanes = [lanes[i] + lanes[i ^ off] for i in range(EM_LANES)]
            off //= 2
        want[kk] = torch.clamp(lanes[0] * float(inv_counts[kk]), _EM_EPS,
                               1.0 - _EM_EPS).numpy()
    np.testing.assert_array_equal(f.numpy(), want)


def test_population_order_tables():
    pop = torch.tensor([2, 0, 1, 0, 2, 2], dtype=torch.int32)
    order, pos, beg = _population_order(pop, 4)
    assert order.tolist() == [1, 3, 2, 0, 4, 5]   # stable within a population
    assert pos.tolist() == [3, 0, 2, 1, 4, 5]     # the inverse permutation
    assert beg.tolist() == [0, 2, 3, 6, 6]        # population 3 is empty
    assert order.dtype == pos.dtype == beg.dtype == torch.int32


@pytest.mark.parametrize("n,k,t,sites,resident", [
    (180, 5, 16, 16, True),   # the headline cohort width: resident, 16 sites
    (24, 3, 5, 16, True),
    (3000, 5, 16, 8, True),   # a narrower block keeps the tile resident
    (7000, 5, 16, 4, True),
    (7300, 5, 16, 4, False),  # wider than shared memory: walked in slices
    (100000, 8, 16, 4, False),
])
def test_geometry(n, k, t, sites, resident):
    s, stride, nc, smem = em_chunk_geometry(n, k, t)
    assert s == sites and s in EM_BLOCK_SITES
    assert (nc == n) == resident
    assert EM_LANES <= nc <= n or nc == n
    assert stride >= nc and stride % 16 == 8   # conflict-free 8-byte loads
    if not resident:
        assert nc % EM_LANES == 0 and stride == nc
    assert smem <= _kernels.SMEM_LIMIT
    assert smem == (16 * k + 8 * s * stride + 4 * k * s
                    + 4 * (s * EM_LANES // 32) * t * k)
    # at the headline width eight blocks, 32 warps, fit an SM's 227 KB
    if n == 180:
        assert _kernels.SMEM_LIMIT // (smem + 1024) >= 8
