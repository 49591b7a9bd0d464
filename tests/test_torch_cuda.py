"""CUDA kernels against their plain PyTorch twins, on the GPU, and the
torch-op analyses on the GPU against the same calls on the CPU.

Every test here needs an NVIDIA GPU and nvcc, and skips without them (the
kernels have no CPU mode).  This file imports neither jax nor the JAX
package's device code, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the kernels round op for op like the twins (-fmad=false, IEEE
division, members summed in the same order: ``em_chunk``'s twin sums
lane-strided partial sums and a butterfly as its kernel does), so ``ft`` agrees to atol 1e-6
and ``sq`` -- summed over sites in another order (warp shuffles, blocks) --
to rtol 1e-5.  The analyses without a kernel (assignment log-likelihoods,
Ne) are held to the CPU at the tolerances of tests/test_torch_assign.py and
tests/test_torch_ne.py; a streamed cohort is bit-identical to an in-memory
one on the card too.
"""

import numpy as np
import pytest
import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import (
    em_chunk,
    em_chunk_geometry,
    em_chunk_twin,
)
from wgsassign_tpu_torch.ops.fused_em import (
    em_maf_loo_group_fused,
    em_maf_loo_subset_fused,
    em_maf_pops_fused,
    em_maf_sites_batch_fused,
)
from wgsassign_tpu_torch.ops.loo_chunk import (
    loo_chunk,
    loo_chunk_geometry,
    loo_chunk_twin,
    max_loo_members,
)
from wgsassign_tpu_torch.ops.sites_chunk import (
    max_sites_members,
    sites_chunk,
    sites_chunk_geometry,
    sites_chunk_twin,
)
from wgsassign_tpu_torch.ops.zloo_chunk import (
    max_zloo_members,
    zloo_chunk,
    zloo_chunk_geometry,
    zloo_chunk_twin,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _gls(rows, cols, seed):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(rows, cols)).astype(np.float32)
    return raw[:, :, 0].copy(), raw[:, :, 1].copy()


def test_probe(cuda):
    before = _kernels.launches["probe"]
    _kernels.probe(cuda)
    assert _kernels.launches["probe"] == before + 1


def test_runtime_probes_once(cuda):
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    rt = make_runtime(cuda)
    before = _kernels.launches["probe"]
    assert rt.kernels_enabled() and rt.kernels_enabled()
    assert _kernels.launches["probe"] == before + 1


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("m,n,k,limits", [
    (1000, 37, 3, [7, 3, 0]),      # resident tile, ragged last block
    (300, 3000, 4, [7, 3, 0, 7]),  # resident in a block of 8 sites
    (70, 7300, 4, [7, 3, 0, 7]),   # wider than shared memory: sliced walk
    # N one over and one under a multiple of 32 and of the 8 lanes; one
    # population and eight; limits of 0 and mixed; M off the 16-site tile
    (72, 33, 3, [7, 7, 7]), (72, 31, 3, [7, 2, 0]),
    (50, 9, 1, [7]), (50, 7, 1, [3]), (50, 8, 1, [0]),
    (100, 65, 8, [7, 0, 1, 7, 2, 0, 3, 7]), (17, 41, 8, [7] * 8),
    (130, 24, 2, [0, 0]),
])
def test_em_chunk_kernel_matches_twin(cuda, fast_math, m, n, k, limits):
    g0, g1 = _gls(m, n, 1)
    rng = np.random.default_rng(2)
    ft = rng.uniform(0.05, 0.95, size=(k, m)).astype(np.float32)
    pop = rng.permutation(np.arange(n) % k).astype(np.int32)
    inv = (1.0 / np.bincount(pop, minlength=k)).astype(np.float32)
    lim = np.asarray(limits, np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (g0, g1, ft, pop, inv, lim)]
    before = _kernels.launches["em_chunk"]
    f_k, sq_k = em_chunk(*args, 7, fast_math=fast_math)
    assert _kernels.launches["em_chunk"] == before + 1
    f_t, sq_t = em_chunk_twin(*args, 7, fast_math=fast_math)
    torch.cuda.synchronize()
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-6)
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


def test_em_chunk_sliced_path_is_reached():
    """The widest case above really leaves the resident path."""
    _, _, nc, _ = em_chunk_geometry(7300, 4, 7)
    assert nc < 7300
    assert em_chunk_geometry(3000, 4, 7)[2] == 3000


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("n_real,p,m,limits", [
    (11, 16, 1000, "mixed"),   # ragged last tile, 16-byte copies elsewhere
    # n_real one over and one under a multiple of 32 and of the problem
    # tile; limits of 0 and mixed; M off the 32-site tile and off 4
    (33, 40, 70, "all"), (31, 32, 70, "mixed"), (5, 8, 257, "mixed"),
    (3, 8, 33, "all"), (2, 8, 64, "all"), (9, 16, 30, "zero"),
    (36, 40, 1001, "mixed"),   # rows not 16-byte aligned: plain loads
])
def test_loo_chunk_kernel_matches_twin(cuda, fast_math, n_real, p, m, limits):
    T = 6
    g0p, g1p = _gls(p, m, 3)
    g0p[n_real:], g1p[n_real:] = 1.0, 0.0
    ft = np.random.default_rng(4).uniform(
        0.05, 0.95, size=(p, m)).astype(np.float32)
    lim = np.zeros(p, np.float32)
    if limits == "all":
        lim[:n_real] = T
    elif limits == "mixed":
        lim[:n_real] = (np.arange(n_real) * 5) % (T + 1)
    args = [torch.from_numpy(a).to(cuda) for a in (g0p, g1p, ft, lim)]
    before = _kernels.launches["loo_chunk"]
    f_k, sq_k = loo_chunk(*args, n_real, T, fast_math=fast_math)
    assert _kernels.launches["loo_chunk"] == before + 1
    f_t, sq_t = loo_chunk_twin(*args, n_real, T, fast_math=fast_math)
    torch.cuda.synchronize()
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-6)
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


@pytest.mark.parametrize("fast_math", [True, False])
def test_loo_chunk_member_bound(cuda, fast_math):
    """At the staging bound and one member above it (the unstaged kernel,
    which reads the members from the global panels) the kernel agrees with
    the twin, on a ragged site axis, with mixed limits."""
    bound, m, T = max_loo_members(), 40, 3
    assert bound == 908
    g0p, g1p = _gls(bound + 1, m, 12)
    ft = np.random.default_rng(13).uniform(
        0.05, 0.95, size=(bound + 1, m)).astype(np.float32)
    g0d, g1d, ftd = (torch.from_numpy(a).to(cuda) for a in (g0p, g1p, ft))
    for n_p in (bound, bound + 1):
        lim = torch.full((n_p,), float(T), device=cuda)
        lim[1], lim[6], lim[n_p - 1] = 0.0, 2.0, 1.0
        args = (g0d[:n_p].contiguous(), g1d[:n_p].contiguous(),
                ftd[:n_p].contiguous(), lim)
        assert (loo_chunk_geometry(n_p)[1] == 0) == (n_p > bound)
        before = _kernels.launches["loo_chunk"]
        f_k, sq_k = loo_chunk(*args, n_p, T, fast_math=fast_math)
        assert _kernels.launches["loo_chunk"] == before + 1
        f_t, sq_t = loo_chunk_twin(*args, n_p, T, fast_math=fast_math)
        torch.cuda.synchronize()
        assert float((f_k - f_t).abs().max()) == 0.0
        torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


def test_wrapper_rejects_bad_operands(cuda):
    g0, g1 = _gls(64, 8, 5)
    args = [torch.from_numpy(a).to(cuda) for a in
            (g0, g1, np.full((2, 64), 0.25, np.float32),
             (np.arange(8) % 2).astype(np.int64),  # wrong index dtype
             np.full(2, 0.25, np.float32), np.full(2, 4, np.float32))]
    with pytest.raises(ValueError, match="pop_index has dtype"):
        em_chunk(*args, 4)


def test_fused_ems_kernel_vs_twin(cuda):
    """Whole chunk/replay runs: equal convergence iterations."""
    m, n, k = 2048, 30, 3
    g0, g1 = _gls(m, n, 6)
    member = np.zeros((n, k), np.float32)
    member[np.arange(n), np.arange(n) % k] = 1.0
    g0d, g1d = torch.from_numpy(g0).to(cuda), torch.from_numpy(g1).to(cuda)
    sw = torch.ones(m, device=cuda)
    f_k, it_k, _ = em_maf_pops_fused(g0d, g1d, member, sw, m, 200, 1e-4)
    f_t, it_t, _ = em_maf_pops_fused(g0d, g1d, member, sw, m, 200, 1e-4,
                                     chunk_op=em_chunk_twin)
    np.testing.assert_array_equal(it_k, it_t)
    np.testing.assert_allclose(f_k, f_t, rtol=0, atol=1e-5)
    g0p, g1p = g0d[:, :10].t().contiguous(), g1d[:, :10].t().contiguous()
    f_k, it_k, _ = em_maf_loo_group_fused(g0p, g1p, m, 200, 1e-4)
    f_t, it_t, _ = em_maf_loo_group_fused(g0p, g1p, m, 200, 1e-4,
                                          chunk_op=loo_chunk_twin)
    np.testing.assert_array_equal(it_k, it_t)
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("n_real,np_pad,m,leave,limits", [
    (11, 16, 1000, [0, 4, 10, 7, 2], [6, 2, 0, 6, 1]),  # ragged last tile
    (11, 16, 1000, [3, 3, 3, 3, 3, 3], [6] * 6),        # repeated
    (11, 11, 996, [10, 8, 5, 1, 0], [6, 6, 3, 6, 6]),   # descending
    (11, 16, 64, [7], [6]),                             # B = 1
    (36, 36, 1001, list(range(13)), [6] * 13),  # rows not 16-byte aligned
    (36, 40, 70, list(range(0, 36, 3)), [6, 0, 6, 1] * 3),  # M off the tile
    (2, 8, 257, [0, 1, 1, 0, 1], [6, 6, 2, 0, 6]),      # n_real = 2
    (33, 40, 330, [32, 0, 31, 1, 16, 16, 2, 32, 5],
     [5, 6, 0, 6, 6, 1, 6, 0, 3]),
    (9, 16, 130, [1, 2, 3, 4], [0, 0, 0, 0]),           # nothing to do
    (11, 16, 100, [11, -1, 3, 40], [6, 6, 6, 6]),  # rows that leave nothing
])
def test_zloo_chunk_kernel_matches_twin(cuda, fast_math, n_real, np_pad, m,
                                        leave, limits):
    T = 6
    b = len(leave)
    g0p, g1p = _gls(np_pad, m, 7)
    g0p[n_real:], g1p[n_real:] = 1.0, 0.0
    rng = np.random.default_rng(8)
    ft = rng.uniform(0.05, 0.95, size=(b, m)).astype(np.float32)
    sw = (rng.random((b, m)) < 0.6).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (g0p, g1p, ft, sw, np.asarray(leave, np.int32),
                      np.asarray(limits, np.float32))]
    before = _kernels.launches["zloo_chunk"]
    f_k, sq_k = zloo_chunk(*args, n_real, T, fast_math=fast_math)
    assert _kernels.launches["zloo_chunk"] == before + 1
    f_t, sq_t = zloo_chunk_twin(*args, n_real, T, fast_math=fast_math)
    torch.cuda.synchronize()
    assert float((f_k - f_t).abs().max()) == 0.0
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)
    torch.testing.assert_close(args[2], torch.from_numpy(ft).to(cuda),
                               rtol=0, atol=0)


def test_zloo_chunk_panel_views(cuda):
    """Member panels that are views at an odd offset (rows 4 bytes off the
    16-byte grid) take the plain staging path."""
    n_real, m, T = 11, 1000, 6
    g0p, g1p = _gls(n_real, m + 1, 7)
    rng = np.random.default_rng(8)
    ft = rng.uniform(0.05, 0.95, size=(3, m)).astype(np.float32)
    flat0 = torch.from_numpy(g0p).to(cuda).reshape(-1)
    flat1 = torch.from_numpy(g1p).to(cuda).reshape(-1)
    v0 = flat0[1:1 + n_real * m].view(n_real, m)
    v1 = flat1[1:1 + n_real * m].view(n_real, m)
    assert v0.data_ptr() % 16 == 4 and v0.is_contiguous()
    args = (v0, v1, torch.from_numpy(ft).to(cuda),
            torch.ones((3, m), device=cuda),
            torch.tensor([0, 5, 10], dtype=torch.int32, device=cuda),
            torch.full((3,), float(T), device=cuda))
    f_k, sq_k = zloo_chunk(*args, n_real, T)
    f_t, sq_t = zloo_chunk_twin(*args, n_real, T)
    torch.cuda.synchronize()
    assert float((f_k - f_t).abs().max()) == 0.0
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


def _sites_case(b, p, s, mask_kind, seed=9):
    raw = np.random.default_rng(seed).dirichlet(np.ones(3), size=(b, p, s))
    g0p = raw[..., 0].astype(np.float32)
    g1p = raw[..., 1].astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    ft = rng.uniform(0.05, 0.95, size=(b, s)).astype(np.float32)
    sw = (rng.random((b, s)) < 0.5).astype(np.float32)
    if mask_kind == "random":
        mask = (rng.random((b, p)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
    elif mask_kind == "ones":
        mask = np.ones((b, p), np.float32)
    elif mask_kind == "interior":  # zeros inside, and one-member problems
        mask = np.ones((b, p), np.float32)
        mask[:, 1:p - 1:2] = 0.0
        mask[0] = 0.0
        mask[0, p - 1] = 1.0
    else:  # "fractional": not 0/1, the multiplied path
        mask = rng.choice([0.0, 0.5, 1.0, 2.0], size=(b, p)).astype(
            np.float32)
        mask[:, 0] = 0.5
    inv = (1.0 / np.maximum(mask.sum(axis=1), 1.0)).astype(np.float32)
    return g0p, g1p, ft, mask, sw, inv


@pytest.mark.parametrize("fast_math", [True, False])
@pytest.mark.parametrize("b,p,s,mask_kind,limits", [
    (4, 9, 700, "random", [5, 0, 2, 5]),     # ragged last site tile
    (4, 300, 700, "random", [5, 0, 2, 5]),   # 64-site tile, 10 bitmap words
    (2, 500, 100, "random", [5, 5]),         # 32-site tile
    (3, 35, 2048, "random", [5, 1, 5]),      # 128-site tile, 16-byte copies
    (3, 35, 1024, "ones", [5, 5, 5]),        # every tile by 16-byte copies
    (3, 35, 1001, "ones", [5, 3, 5]),        # rows not 16-byte aligned
    (5, 33, 330, "interior", [5, 5, 0, 1, 5]),
    (5, 12, 330, "fractional", [5, 5, 0, 1, 5]),
    (1, 2, 33, "ones", [5]),                 # B = 1, two members
    (2, 1, 64, "ones", [5, 5]),              # one member
    (3, 40, 96, "random", [0, 0, 0]),        # nothing to do
])
def test_sites_chunk_kernel_matches_twin(cuda, fast_math, b, p, s, mask_kind,
                                         limits):
    T = 5
    g0p, g1p, ft, mask, sw, inv = _sites_case(b, p, s, mask_kind)
    lim = np.asarray(limits, np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (g0p, g1p, ft, mask, sw, lim, inv)]
    before = _kernels.launches["sites_chunk"]
    f_k, sq_k = sites_chunk(*args, T, fast_math=fast_math)
    assert _kernels.launches["sites_chunk"] == before + 1
    f_t, sq_t = sites_chunk_twin(*args, T, fast_math=fast_math)
    torch.cuda.synchronize()
    assert float((f_k - f_t).abs().max()) == 0.0
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)
    torch.testing.assert_close(args[2], torch.from_numpy(ft).to(cuda),
                               rtol=0, atol=0)


def test_sites_chunk_finished_problem_with_nan_panel(cuda):
    """A problem at limit 0 is copied through with sq = 0 though its panel
    holds NaN: its block never reads the panel."""
    T = 5
    g0p, g1p, ft, mask, sw, inv = _sites_case(3, 9, 200, "random")
    g0p[1] = np.nan
    lim = np.asarray([5, 0, 2], np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (g0p, g1p, ft, mask, sw, lim, inv)]
    f_k, sq_k = sites_chunk(*args, T)
    f_t, sq_t = sites_chunk_twin(*args, T)
    torch.cuda.synchronize()
    assert torch.equal(f_k, f_t)
    assert torch.equal(f_k[1], args[2][1])
    assert float(sq_k[:, 1].abs().max()) == 0.0
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


def test_zloo_above_the_staging_bound(cuda):
    """At the staging bound and one member above it (the unstaged kernel)
    the kernel agrees with the twin, whatever T and B."""
    bound, m, T = max_zloo_members(), 40, 2
    assert bound == 908
    g0p, g1p = _gls(bound + 1, m, 12)
    g0d, g1d = torch.from_numpy(g0p).to(cuda), torch.from_numpy(g1p).to(cuda)
    rest = (torch.full((5, m), 0.25, device=cuda),
            torch.ones((5, m), device=cuda),
            torch.tensor([0, 500, 907, 907, 3], dtype=torch.int32,
                         device=cuda),
            torch.tensor([2.0, 2.0, 1.0, 0.0, 2.0], device=cuda))
    for n_p in (bound, bound + 1):
        args = (g0d[:n_p].contiguous(), g1d[:n_p].contiguous(), *rest)
        assert (zloo_chunk_geometry(n_p, 5)[1] == 0) == (n_p > bound)
        before = _kernels.launches["zloo_chunk"]
        f_k, sq_k = zloo_chunk(*args, n_p, T)
        assert _kernels.launches["zloo_chunk"] == before + 1
        f_t, sq_t = zloo_chunk_twin(*args, n_p, T)
        torch.cuda.synchronize()
        assert float((f_k - f_t).abs().max()) == 0.0
        torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mask_kind", ["random", "fractional"])
def test_sites_above_the_staging_bound(cuda, mask_kind):
    """At the staging bound and one member above it (the unstaged kernel)
    the kernel agrees with the twin, for 0/1 masks and for masks with other
    values."""
    bound, s, T = max_sites_members(), 40, 2
    assert bound == 907
    g0p, g1p, ft, mask, sw, _ = _sites_case(2, bound + 1, s, mask_kind, 14)
    full = [torch.from_numpy(a).to(cuda) for a in (g0p, g1p, ft, mask, sw)]
    lim = torch.tensor([float(T), 1.0], device=cuda)
    for p in (bound, bound + 1):
        invd = torch.from_numpy((1.0 / (mask[:, :p] != 0).sum(axis=1)).astype(
            np.float32)).to(cuda)
        args = (full[0][:, :p].contiguous(), full[1][:, :p].contiguous(),
                full[2], full[3][:, :p].contiguous(), full[4], lim, invd)
        assert (sites_chunk_geometry(p)[1] == 0) == (p > bound)
        before = _kernels.launches["sites_chunk"]
        f_k, sq_k = sites_chunk(*args, T)
        assert _kernels.launches["sites_chunk"] == before + 1
        f_t, sq_t = sites_chunk_twin(*args, T)
        torch.cuda.synchronize()
        assert float((f_k - f_t).abs().max()) == 0.0
        torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


def test_zscore_fused_ems_kernel_vs_twin(cuda):
    """Whole chunk/replay runs of the two z-score EMs: equal iterations."""
    g0p, g1p = _gls(12, 3000, 11)
    rng = np.random.default_rng(12)
    sw = torch.from_numpy((rng.random((5, 3000)) < 0.8).astype(
        np.float32)).to(cuda)
    g0d, g1d = torch.from_numpy(g0p).to(cuda), torch.from_numpy(g1p).to(cuda)
    leave = np.asarray([0, 3, 5, 8, 11], np.int32)
    m_real = sw.sum(dim=1).cpu().numpy()
    f_k, it_k, _ = em_maf_loo_subset_fused(g0d, g1d, leave, sw, m_real,
                                           200, 1e-4)
    f_t, it_t, _ = em_maf_loo_subset_fused(g0d, g1d, leave, sw, m_real,
                                           200, 1e-4,
                                           chunk_op=zloo_chunk_twin)
    np.testing.assert_array_equal(it_k, it_t)
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-5)

    raw = np.random.default_rng(13).dirichlet(np.ones(3), size=(6, 10, 2048))
    g0s = torch.from_numpy(raw[..., 0].astype(np.float32)).to(cuda)
    g1s = torch.from_numpy(raw[..., 1].astype(np.float32)).to(cuda)
    mask = np.ones((6, 10), np.float32)
    mask[2, 7:] = 0.0
    kept = np.asarray([2048, 1500, 900, 2000, 64, 1024])
    sws = (np.arange(2048)[None, :] < kept[:, None]).astype(np.float32)
    f_k, it_k, _ = em_maf_sites_batch_fused(g0s, g1s, mask, sws, kept,
                                            200, 1e-4)
    f_t, it_t, _ = em_maf_sites_batch_fused(g0s, g1s, mask, sws, kept,
                                            200, 1e-4,
                                            chunk_op=sites_chunk_twin)
    np.testing.assert_array_equal(it_k, it_t)
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-5)


def _beagle(m, n, seed):
    from wgsassign_tpu_torch.io.beagle import BeagleData

    raw = np.random.default_rng(seed).dirichlet(np.ones(3), size=(m, n))
    gl = np.ascontiguousarray(raw[:, :, :2].astype(np.float32))
    return BeagleData(gl, [f"Ind{i}" for i in range(n)],
                      [f"s{j}" for j in range(m)])


@pytest.mark.parametrize("f64_sums", [True, False])
@pytest.mark.parametrize("p", [1, 4])
def test_assignment_loglikelihoods_card_vs_cpu(cuda, p, f64_sums):
    from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = _beagle(4000, 40, 14)
    af = np.random.default_rng(15).uniform(
        0.02, 0.98, size=(4000, 3)).astype(np.float32)
    kw = dict(num_partitions=p, f64_sums=f64_sums)
    got = assignment_loglikelihoods(beagle, af, runtime=make_runtime(cuda),
                                    **kw)
    want = assignment_loglikelihoods(beagle, af,
                                     runtime=make_runtime("cpu"), **kw)
    for g, w in zip(*((got, want) if p > 1 else ((got,), (want,)))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-3)
    ll_g, ll_w = (got[0], want[0]) if p > 1 else (got, want)
    np.testing.assert_array_equal(ll_g.argmax(1), ll_w.argmax(1))


def test_effective_sample_sizes_card_vs_cpu(cuda):
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.models.ne import effective_sample_sizes
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = _beagle(4000, 40, 16)
    popmap = population_map(beagle.sample_names,
                            [f"pop{i % 3}" for i in range(40)])
    af = np.random.default_rng(17).uniform(
        0.05, 0.95, size=(4000, 3)).astype(np.float32)
    got = effective_sample_sizes(beagle, af, popmap,
                                 runtime=make_runtime(cuda), site_block=999)
    want = effective_sample_sizes(beagle, af, popmap,
                                  runtime=make_runtime("cpu"))
    for name in ("f_obs", "ne_obs", "ne_ind"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("keep", [False, True])
def test_stream_to_device_card_bitmatches(cuda, tmp_path, monkeypatch, keep,
                                         overlap):
    """Pinned staging buffers, side-stream copies and on-card plane splits
    give the in-memory cohort bit for bit."""
    from wgsassign_tpu_torch.io.beagle import BeagleData, read_beagle
    from wgsassign_tpu_torch.io.synth import write_beagle
    from wgsassign_tpu_torch.models.common import stream_to_device, to_device
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    monkeypatch.setenv("WGSA_STREAM_OVERLAP", overlap)
    path = str(tmp_path / "c.beagle.gz")
    write_beagle(path, _beagle(3001, 24, 18).gl)
    full = read_beagle(path)
    keep_mask = None
    if keep:
        keep_mask = np.arange(3001) % 3 != 1
        rows = np.flatnonzero(keep_mask)
        full = BeagleData(full.gl[rows], full.sample_names,
                          [full.site_names[r] for r in rows])
    rt = make_runtime(cuda)
    got, _, _ = stream_to_device(path, rt, site_multiple=4, block_rows=256,
                                 keep_mask=keep_mask)
    want = to_device(full, rt, site_multiple=4)
    torch.cuda.synchronize()
    assert got.m_real == want.m_real
    for name in ("g0", "g1", "site_weight"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _big_population(m, seed):
    """909 members (one above the loo_chunk and zloo_chunk bounds) beside a
    population of 11, with allele depths."""
    from wgsassign_tpu_torch.io.beagle import BeagleData
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.io.synth import synth_cohort

    n = 909 + 11
    gl, _, ad = synth_cohort(m, n, n_pops=2, seed=seed)
    names = [f"Ind{i}" for i in range(n)]
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(m)])
    return beagle, population_map(names, ["big"] * 909 + ["small"] * 11), ad


def test_loo_of_909_members_runs_the_kernel_on_the_card(cuda, caplog):
    """A population whose member tile does not fit in shared memory runs
    ``loo_chunk`` all the same (its unstaged form): no warning, no plain op,
    and the result agrees with the CPU run's."""
    import logging

    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    assert max_loo_members() == 908
    beagle, popmap, _ = _big_population(256, 21)
    cohort = to_device(beagle, make_runtime(cuda))
    ref = estimate_reference_af(beagle, popmap, cohort=cohort)
    logger = logging.getLogger("wgsassign_tpu")
    logger.addHandler(caplog.handler)
    before = _kernels.launches["loo_chunk"]
    try:
        got = leave_one_out(beagle, ref.af, popmap, max_iter=3,
                            cohort=cohort, af_t_dev=ref.af_t_dev)
    finally:
        logger.removeHandler(caplog.handler)
    assert got.engines == ("loo_chunk", "loo_chunk")
    assert _kernels.launches["loo_chunk"] >= before + 2
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    want = leave_one_out(beagle, ref.af, popmap, max_iter=3,
                         runtime=make_runtime("cpu"))
    assert want.engines == got.engines
    np.testing.assert_array_equal(got.iters, want.iters)
    np.testing.assert_allclose(got.ll, want.ll, rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(got.ll.argmax(1), want.ll.argmax(1))


def test_reference_z_of_909_members_runs_the_kernel_on_the_card(cuda):
    """The same for the z-score EM: the big population's individuals and the
    small one's all take ``zloo_chunk``."""
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.zscore import reference_z_scores
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    assert max_zloo_members() == 908
    beagle, popmap, ad = _big_population(4096, 22)
    kw = dict(ind_start=907, ind_end=911, max_iter=3)
    before = _kernels.launches["zloo_chunk"]
    got = reference_z_scores(beagle, ad, popmap, **kw,
                             cohort=to_device(beagle, make_runtime(cuda)))
    assert got.structure == "loo-structured"
    assert got.engine == "zloo_chunk"
    assert _kernels.launches["zloo_chunk"] >= before + 2
    want = reference_z_scores(beagle, ad, popmap, **kw,
                              runtime=make_runtime("cpu"))
    np.testing.assert_array_equal(got.loci, want.loci)
    np.testing.assert_array_equal(got.em_iters, want.em_iters)
    assert np.isfinite(got.z).all()
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=2e-3)


def test_no_pallas_runs_no_kernel_on_the_card(cuda):
    """``use_kernels=False`` (--no_pallas): the plain ops on the card, no
    EM kernel launched, equal iterations and AF to the kernels' run."""
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = _beagle(3000, 30, 23)
    popmap = population_map(beagle.sample_names,
                            [f"pop{i % 3}" for i in range(30)])
    runs = {}
    for use_kernels in (False, None):
        _kernels.launches.clear()
        cohort = to_device(beagle, make_runtime(cuda, use_kernels=use_kernels))
        ref = estimate_reference_af(beagle, popmap, cohort=cohort)
        loo = leave_one_out(beagle, ref.af, popmap, cohort=cohort,
                            af_t_dev=ref.af_t_dev)
        runs[use_kernels] = (ref, loo, dict(_kernels.launches))
    plain, fused = runs[False], runs[None]
    assert not plain[2].get("em_chunk") and not plain[2].get("loo_chunk")
    assert fused[2]["em_chunk"] and fused[2]["loo_chunk"]
    assert plain[0].engine == "plain" and set(plain[1].engines) == {"plain"}
    np.testing.assert_array_equal(plain[0].iters, fused[0].iters)
    np.testing.assert_array_equal(plain[1].iters, fused[1].iters)
    np.testing.assert_allclose(plain[0].af, fused[0].af, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain[1].ll, fused[1].ll, rtol=1e-5, atol=2e-3)


def test_kernels_build_and_probe_under_a_compile_cache(cuda, tmp_path):
    """``WGSA_COMPILE_CACHE=<dir>``: a fresh process builds the kernel
    library under ``<dir>`` and its probe runs."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch\n"
        "from wgsassign_tpu_torch import _kernels\n"
        "_kernels.probe(torch.device('cuda:0'))\n"
        "print(_kernels.library_path())\n"
    )
    env = dict(os.environ, WGSA_COMPILE_CACHE=str(tmp_path), PYTHONPATH=root)
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    lib = run.stdout.strip().splitlines()[-1]
    assert lib.startswith(str(tmp_path / "wgsassign_tpu_torch_kernels"))
    assert os.path.exists(lib)
    assert os.path.exists(os.path.join(os.path.dirname(lib), "ptxas.log"))


def test_entry_runs_em_chunk_once_on_the_card(cuda):
    """``entry()`` runs on the card by default, its step launches
    ``em_chunk`` once, and ``f_new`` equals the CPU step (the kernel is
    bit-equal to its twin) with the log-likelihoods to rtol 1e-5, atol
    2e-3."""
    from wgsassign_tpu_torch.graft_entry import entry

    module, args = entry()
    assert all(a.device == cuda for a in args)
    before = _kernels.launches["em_chunk"]
    f_new, ll = module(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["em_chunk"] == before + 1
    cpu_module, cpu_args = entry("cpu")
    f_cpu, ll_cpu = cpu_module(*cpu_args)
    assert torch.equal(f_new.cpu(), f_cpu)
    torch.testing.assert_close(ll.cpu(), ll_cpu, rtol=1e-5, atol=2e-3)


def test_dryrun_multichip_on_the_card(cuda):
    """Two ranks: each on a card of its own over NCCL where the host has
    two, both on ``cuda:0`` over gloo where it has one."""
    from wgsassign_tpu_torch.graft_entry import dryrun_multichip

    got = dryrun_multichip(2)
    own_cards = torch.cuda.device_count() >= 2
    assert str(got["backend"]) == ("nccl" if own_cards else "gloo")
    assert got["devices"].tolist() == (
        ["cuda:0", "cuda:1"] if own_cards else ["cuda:0", "cuda:0"])
    assert int(got["launches_em_chunk"]) >= 1
    assert int(got["launches_loo_chunk"]) >= 1
    assert int(got["launches_zloo_chunk"]) >= 1


def test_a_span_times_the_cuda_stream(cuda, monkeypatch):
    """While a profiler records, a span times its work on the card from two
    stream events, without synchronizing; the totals wait for them."""
    import wgsassign_tpu_torch.obs.profiling as prof
    from collections import defaultdict
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(prof, "_spans", defaultdict(list))
    x = torch.rand(4096, 4096, device=cuda)
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a span synchronized")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", refuse)
            m.setattr(torch.cuda.Event, "synchronize", refuse)
            with prof.span("wgsa.test.matmul"):
                for _ in range(4):
                    y = x @ x
    got = prof.span_totals()["wgsa.test.matmul"]
    assert got["calls"] == 1
    assert got["device_s"] > 0 and got["host_s"] > 0
    assert torch.isfinite(y).all()
