"""The port's sites-batch chunk (``wgsassign_tpu_torch.ops.sites_chunk``)
against the JAX package's Pallas sites chunk kernel, run in interpret mode
on the CPU.

Tolerances: ``ft`` atol 2e-6, ``sq`` rtol 1e-5 (member sums in another
order than the Pallas reduction), as test_torch_loo_chunk.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from wgsassign_tpu.ops.pallas_emmaf import sites_chunk_pallas
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.sites_chunk import (
    SITES_WARPS,
    max_sites_members,
    sites_chunk,
    sites_chunk_geometry,
    sites_chunk_twin,
)

B, P, S, T = 5, 9, 128, 4


def _sites_inputs(b=B, p=P, s=S, seed=7):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(b, p, s)).astype(np.float32)
    g0p, g1p = raw[..., 0].copy(), raw[..., 1].copy()
    ft = rng.uniform(0.05, 0.95, size=(b, s)).astype(np.float32)
    mask = (rng.random((b, p)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0  # at least one member per problem
    sw = (rng.random((b, s)) < 0.6).astype(np.float32)
    inv = (1.0 / mask.sum(axis=1)).astype(np.float32)
    return g0p, g1p, ft, mask, sw, inv


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("limits", [
    [4, 4, 4, 4, 4],   # every problem runs the whole chunk
    [4, 1, 0, 3, 4],   # mixed per-problem limits (a replay)
])
def test_twin_matches_pallas_chunk(fast_math, limits):
    g0p, g1p, ft, mask, sw, inv = _sites_inputs()
    lim = np.asarray(limits, np.float32)
    f_ref, sq_ref = sites_chunk_pallas(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(ft[:, None, :]),
        jnp.asarray(mask[:, None, :]), jnp.asarray(sw[:, None, :]),
        jnp.asarray(lim.reshape(B, 1, 1)), jnp.asarray(inv.reshape(B, 1, 1)),
        T, interpret=True, fast_math=fast_math,
    )
    f, sq = sites_chunk(*map(torch.from_numpy,
                             (g0p, g1p, ft, mask, sw, lim, inv)),
                        T, fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref)[:, 0, :], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)
    for b in np.flatnonzero(lim == 0):
        np.testing.assert_array_equal(f.numpy()[b], ft[b])


def test_wrapper_runs_twin_on_cpu_and_keeps_input():
    g0p, g1p, ft, mask, sw, inv = _sites_inputs(s=40)
    args = [torch.from_numpy(a) for a in
            (g0p, g1p, ft, mask, sw, np.full(B, 3, np.float32), inv)]
    ft_before = args[2].clone()
    before = _kernels.launches["sites_chunk"]
    f_w, sq_w = sites_chunk(*args, 3)
    f_t, sq_t = sites_chunk_twin(*args, 3)
    torch.testing.assert_close(f_w, f_t, rtol=0, atol=0)
    torch.testing.assert_close(sq_w, sq_t, rtol=0, atol=0)
    torch.testing.assert_close(args[2], ft_before, rtol=0, atol=0)
    assert _kernels.launches["sites_chunk"] == before


def _interior_zeros(mask):
    mask[:] = 1.0
    mask[:, [2, 3, 6]] = 0.0
    mask[1] = 0.0
    mask[1, 4] = 1.0  # one member only
    return mask


def _fractional(mask):
    mask[:] = np.random.default_rng(8).choice(
        [0.0, 0.5, 1.0, 2.0], size=mask.shape).astype(np.float32)
    mask[:, 0] = 0.5
    return mask


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("remask", [_interior_zeros, _fractional])
def test_twin_matches_pallas_chunk_masks(fast_math, remask):
    """Masks the CUDA kernel special-cases (it packs the rows of a 0/1
    mask, and multiplies by any other) are plain in the twin: it must agree
    with the Pallas kernel on them."""
    g0p, g1p, ft, mask, sw, _ = _sites_inputs()
    mask = remask(mask)
    inv = (1.0 / np.maximum(mask.sum(axis=1), 1.0)).astype(np.float32)
    lim = np.asarray([4, 4, 2, 0, 4], np.float32)
    f_ref, sq_ref = sites_chunk_pallas(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(ft[:, None, :]),
        jnp.asarray(mask[:, None, :]), jnp.asarray(sw[:, None, :]),
        jnp.asarray(lim.reshape(B, 1, 1)), jnp.asarray(inv.reshape(B, 1, 1)),
        T, interpret=True, fast_math=fast_math,
    )
    f, sq = sites_chunk_twin(*map(torch.from_numpy,
                                  (g0p, g1p, ft, mask, sw, lim, inv)),
                             T, fast_math=fast_math)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref)[:, 0, :], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("fast_math", [True, False])
def test_twin_copies_finished_problem_with_nan_panel(fast_math):
    """A problem at limit 0 is copied through and adds nothing to sq, even
    where its panel holds NaN; the other problems do not see it."""
    g0p, g1p, ft, mask, sw, inv = _sites_inputs()
    lim = np.asarray([4, 0, 3, 4, 0], np.float32)
    clean = [torch.from_numpy(a) for a in (g0p, g1p, ft, mask, sw, lim, inv)]
    f_clean, sq_clean = sites_chunk_twin(*clean, T, fast_math=fast_math)
    g0p[1], g1p[4, 2] = np.nan, np.nan
    dirty = [torch.from_numpy(a) for a in (g0p, g1p, ft, mask, sw, lim, inv)]
    f, sq = sites_chunk_twin(*dirty, T, fast_math=fast_math)
    torch.testing.assert_close(f, f_clean, rtol=0, atol=0)
    torch.testing.assert_close(sq, sq_clean, rtol=0, atol=0)
    for i in (1, 4):
        np.testing.assert_array_equal(f.numpy()[i], ft[i])
        np.testing.assert_array_equal(sq.numpy()[:, i], 0.0)


@pytest.mark.parametrize("p,warps,smem", [
    # the headline population less the scored individual: 6 blocks of 4
    # warps are resident, as many warps as narrower tiles would hold
    (35, 4, 35864),
    (32, 2, 16400),     # one bitmap word; 13 blocks of 2 warps
    (33, 4, 33816),     # two
    (226, 4, 231496),   # the widest panel a 128-site tile takes
    (227, 1, 58184),    # 3 blocks of 1 warp beat 1 block of 2
    (300, 2, 153688),
    (800, 1, 205008),
    (907, 1, 232432),
])
def test_geometry_picks_tile_and_counts_bitmap(p, warps, smem):
    assert sites_chunk_geometry(p) == (warps, smem)
    assert warps in SITES_WARPS and smem <= _kernels.SMEM_LIMIT


def test_member_bound_raises():
    bound = max_sites_members()
    assert bound == 907
    assert 0 < sites_chunk_geometry(bound)[1] <= _kernels.SMEM_LIMIT
    # nothing raises above it any more: the geometry asks for the kernel's
    # unstaged form (no shared memory) at the widest tile
    for p in (bound + 1, 5000):
        assert sites_chunk_geometry(p) == (SITES_WARPS[0], 0)
