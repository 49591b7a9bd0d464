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
to rtol 1e-5.  The ``loglik`` kernel forms each float32 term as its plain
form does, bit for bit, and sums them in another order: float64 sums agree
to 1e-12; so does the ``zsums`` kernel (the z sums) with its twin.  The analyses (assignment log-likelihoods, Ne) are held to the
CPU at the tolerances of tests/test_torch_assign.py and
tests/test_torch_ne.py; a streamed cohort is bit-identical to an in-memory
one on the card too.
"""

import numpy as np
import pytest
import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops import loglik as ll_ops
from wgsassign_tpu_torch.ops.em_chunk import (
    em_chunk,
    em_chunk_geometry,
    em_chunk_twin,
)
from wgsassign_tpu_torch.ops.em_decide import Convergence
from wgsassign_tpu_torch.ops.fused_em import (
    FLAG_LAG,
    _device_init_ft,
    _drive_chunks,
    em_maf_loo_group_fused,
    em_maf_loo_subset_fused,
    em_maf_pops_fused,
    em_maf_sites_batch_fused,
)
from wgsassign_tpu_torch.ops.loo_chunk import (
    loo_chunk_geometry,
    loo_chunk_twin,
    loo_step,
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
    zloo_chunk_geometry,
    zloo_chunk_twin,
    zloo_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _steps_as_chunk(step, ft, lim, T):
    """The twins' chunk contract from the one-iteration kernels: T launches
    of ``step(f, limits)`` on a copy of ``ft``, problem j running while
    ``lim[j] > t``.  Returns ``(f, sq [T, P])``, each launch's per-block
    partials summed as the EM driver sums them (float64, then float32), a
    stopped problem's sum 0."""
    f = ft.clone()
    sq = []
    for t in range(T):
        run = lim > t
        part = step(f, run.to(torch.float32))
        s = torch.sum(part, 0, dtype=torch.float64).to(torch.float32)
        sq.append(torch.where(run, s, 0.0))
    return f, torch.stack(sq)


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
    rt.load_kernels()
    rt.load_kernels()
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
    f_k, sq_k = _steps_as_chunk(
        lambda f, run: loo_step(args[0], args[1], f, run, n_real, fast_math),
        args[2], args[3], T)
    assert _kernels.launches["loo_chunk"] == before + T
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
        f_k, sq_k = _steps_as_chunk(
            lambda f, run: loo_step(args[0], args[1], f, run, n_p, fast_math),
            args[2], lim, T)
        assert _kernels.launches["loo_chunk"] == before + T
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
    g0d, g1d, bank, col, sw = _loglik_operands(cuda, 64, 8, 3, 2, 0, 5)
    f64 = torch.float64
    for bad, match in (
            ((g0d.double(), g1d, bank, col, sw, 1, f64), "g0 has dtype"),
            ((g0d, g1d, bank, col.long(), sw, 1, f64), "col_idx has dtype"),
            ((g0d, g1d.t().contiguous().t(), bank, col, sw, 1, f64),
             "g1 must be contiguous"),
            ((g0d, g1d, bank[:, :60], col, sw, 1, f64),
             "af_bank_t has shape"),
            ((g0d, g1d, bank, col, sw.cpu(), 1, f64), "site_weight is on"),
            ((g0d, g1d, bank, col, sw, 3, f64), "multiple of num_partitions"),
            ((g0d, g1d, bank, col, sw, 1, torch.float16), "sums in")):
        with pytest.raises(ValueError, match=match):
            ll_ops.loglik_sums(*bad)


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
    f_k, sq_k = _steps_as_chunk(
        lambda f, run: zloo_step(args[0], args[1], f, args[3], args[4], run,
                                 n_real, fast_math),
        args[2], args[5], T)
    assert _kernels.launches["zloo_chunk"] == before + T
    f_t, sq_t = zloo_chunk_twin(*args, n_real, T, fast_math=fast_math)
    torch.cuda.synchronize()
    assert float((f_k - f_t).abs().max()) == 0.0
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)
    stopped = args[5] == 0
    assert torch.equal(f_k[stopped], args[2][stopped])


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
    f_k, sq_k = _steps_as_chunk(
        lambda f, run: zloo_step(v0, v1, f, args[3], args[4], run, n_real),
        args[2], args[5], T)
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
        f_k, sq_k = _steps_as_chunk(
            lambda f, run: zloo_step(args[0], args[1], f, args[3], args[4],
                                     run, n_p),
            args[2], args[5], T)
        assert _kernels.launches["zloo_chunk"] == before + T
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


def _loo_panels(cuda, n_p, m, seed):
    g0, g1 = _gls(m, n_p, seed)
    return (torch.from_numpy(np.ascontiguousarray(g0.T)).to(cuda),
            torch.from_numpy(np.ascontiguousarray(g1.T)).to(cuda))


def _chunks_with_replays(step, ft, p, m_real):
    """The driver with T = 8 chunks, the host's test and replays that ran
    the LOO kernels before they took one iteration a launch, each chunk
    made of ``step``'s launches (:func:`_steps_as_chunk`, which equals the
    T-iteration kernel's chunk to the bit)."""
    def run_chunk(ft_in, lv, T):
        lim = torch.from_numpy(lv).to(ft_in.device)
        return _steps_as_chunk(step, ft_in, lim, T)

    f, it, active = _drive_chunks(run_chunk, None, ft, p, 200, 1e-4, m_real,
                                  8, None, name="test_chunks")
    return f, it, ~active


def test_loo_ems_stop_on_the_card_as_chunks_and_replays(cuda):
    """``em_maf_loo_group_fused`` and ``em_maf_loo_subset_fused``: one
    iteration a launch with the test on the card against the kernels' T = 8
    chunks with the host's test and replays: equal iterations and
    convergence, ``f`` bit for bit; every launched problem-iteration
    useful, and at most ``FLAG_LAG`` launches after the last stop."""
    import wgsassign_tpu_torch.obs.profiling as prof
    from torch.profiler import profile

    n_p, m = 24, 3000
    g0p, g1p = _loo_panels(cuda, n_p, m, 31)
    before = prof.counters()
    with profile():
        got = em_maf_loo_group_fused(g0p, g1p, m, 200, 1e-4)
    counts = {k: v - before.get(k, 0) for k, v in prof.counters().items()}

    def loo_run(f, run):
        return loo_step(g0p, g1p, f, run, n_p)

    want = _chunks_with_replays(loo_run, _device_init_ft((n_p, m), m, cuda),
                                n_p, m)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    tails = counts["loo_chunk.tail_launches"]
    assert 0 <= tails <= FLAG_LAG
    assert counts["loo_chunk.launches"] == int(got[1].max()) + tails
    assert counts["loo_chunk.launched_iters"] == counts[
        "loo_chunk.useful_iters"] == int(got[1].sum())
    assert counts.get("loo_chunk.replays", 0) == 0

    leave = np.asarray([0, 3, 5, 8, 11, 23, 30], np.int32)
    rng = np.random.default_rng(32)
    sw = torch.from_numpy((rng.random((leave.size, m)) < 0.85).astype(
        np.float32)).to(cuda)
    m_real = sw.sum(dim=1).cpu().numpy()
    got = em_maf_loo_subset_fused(g0p, g1p, leave, sw, m_real, 200, 1e-4)
    leave_d = torch.from_numpy(leave).to(cuda)

    def zloo_run(f, run):
        return zloo_step(g0p, g1p, f, sw, leave_d, run, n_p)

    want = _chunks_with_replays(
        zloo_run, torch.full((leave.size, m), 0.25, device=cuda), leave.size,
        m_real)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("rows,p", [(1, 5), (157, 13), (5000, 49),
                                    (2000, 300)])
def test_decide_kernel_sums_and_tests_as_the_host(cuda, rows, p):
    """``Convergence.update`` on the card: the float32 sums equal
    ``torch.sum(sq_part, 0, dtype=float64).to(float32)`` (0 for a stopped
    problem), and the stops, iterations and counts are the host's numpy
    test's, with and without a reduce between the summing and the testing
    launch; a NaN sum never converges, a negative one does."""
    rng = np.random.default_rng(rows + p)
    part = rng.exponential(1e-6, (rows, p)).astype(np.float32)
    part[0, 1] = np.nan
    part[:, 2] = -part[:, 2]
    part_d = torch.from_numpy(part).to(cuda)
    want_sq = torch.sum(part_d, 0, dtype=torch.float64).to(torch.float32)
    m_real = rng.uniform(0.5, 2.0, p) * rows
    rmse = np.sqrt(np.maximum(want_sq.cpu().numpy(), 0.0) / m_real)
    tol = float(np.nanmedian(rmse))
    active = np.ones(p, bool)
    active[3] = False
    iters0 = np.full(p, 60, np.int32)
    iters0[3] = 4
    stop = active & (rmse < tol)
    sums = []

    def reduce(sq):
        sums.append(sq.clone())
        return sq

    for red in (None, reduce):
        conv = Convergence(iters0, active, m_real, tol, cuda)
        conv.update(part_d, 6, red)
        iters, act, ran, tails = conv.fetch()
        np.testing.assert_array_equal(iters, np.where(stop, 7, iters0))
        np.testing.assert_array_equal(act, active & ~stop)
        assert (ran, tails) == (int(active.sum()), 0)
        assert int(conv.stats[2]) == int((active & ~stop).sum())
    torch.testing.assert_close(sums[0][active], want_sq[active], rtol=0,
                               atol=0, equal_nan=True)
    assert not sums[0][~active].any()
    assert 1 not in np.flatnonzero(stop) and 2 in np.flatnonzero(stop)
    # with every problem stopped the launch is a tail launch
    conv.update(part_d, 7)
    conv.limits.zero_()
    conv.update(part_d, 8)
    assert conv.fetch()[3] == 1


def test_steps_update_in_place(cuda):
    """``loo_step`` and ``zloo_step`` equal one iteration of the twins, in
    place; a stopped problem's row is left as it was, and with every limit
    at 0 nothing changes."""
    n_p, m = 11, 1001
    g0p, g1p = _loo_panels(cuda, n_p, m, 33)
    ft = torch.from_numpy(np.random.default_rng(34).uniform(
        0.05, 0.95, (n_p, m)).astype(np.float32)).to(cuda)
    lim = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0,
                        1.0], device=cuda)
    f_t, sq_t = loo_chunk_twin(g0p, g1p, ft, lim, n_p, 1)
    f_k = ft.clone()
    part = loo_step(g0p, g1p, f_k, lim, n_p)
    assert part.shape == (-(-m // 32), n_p)
    assert torch.equal(f_k, f_t)
    run = lim > 0
    torch.testing.assert_close(part.sum(0)[run], sq_t[0, run], rtol=1e-5,
                               atol=0)
    assert not part[:, ~run].any()
    loo_step(g0p, g1p, f_k, torch.zeros_like(lim), n_p)
    assert torch.equal(f_k, f_t)

    leave = torch.tensor([4, 0, 9, 2, 7], dtype=torch.int32, device=cuda)
    sw = torch.from_numpy((np.random.default_rng(35).random((5, m)) < 0.8)
                          .astype(np.float32)).to(cuda)
    ftz = ft[:5].clone()
    limz = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0], device=cuda)
    f_t, sq_t = zloo_chunk_twin(g0p, g1p, ftz, sw, leave, limz, n_p, 1)
    part = zloo_step(g0p, g1p, ftz, sw, leave, limz, n_p)
    assert part.shape == (-(-m // 32), 5)
    assert torch.equal(ftz, f_t)
    run = limz > 0
    torch.testing.assert_close(part.sum(0)[run], sq_t[0, run], rtol=1e-5,
                               atol=0)
    assert not part[:, ~run].any()
    zloo_step(g0p, g1p, ftz, sw, leave, torch.zeros_like(limz), n_p)
    assert torch.equal(ftz, f_t)


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


def _loglik_operands(dev, m, n, c, ks, pad, seed):
    """GLs with the padding pattern (1, 0) on the last ``pad`` sites and on
    ~2% of the other cells, a ``[c, m]`` bank with ~20% of its values at
    the clamp edges (the EM bounds, a population of 30's clamp, the PAD
    0.5), and random bank rows per pair; all on ``dev``."""
    rng = np.random.default_rng(seed)
    g0, g1 = _gls(m, n, seed)
    g0[m - pad:], g1[m - pad:] = 1.0, 0.0
    cells = rng.integers(0, m * n, size=max(1, m * n // 50))
    g0.reshape(-1)[cells], g1.reshape(-1)[cells] = 1.0, 0.0
    bank = rng.uniform(0.02, 0.98, size=(c, m)).astype(np.float32)
    edges = np.float32([1e-7, 1.0 - 1e-7, 1.0 / 60.0, 1.0 - 1.0 / 60.0, 0.5])
    at_edge = rng.random((c, m)) < 0.2
    bank[at_edge] = rng.choice(edges, size=int(at_edge.sum()))
    col = rng.integers(0, c, size=(n, ks)).astype(np.int32)
    sw = np.ones(m, np.float32)
    sw[m - pad:] = 0.0
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (g0, g1, bank, col, sw))


def _loglik_pair(args, p, kernel):
    """``(ll [N, Ks], parts [N, Ks, P])`` float64 by the kernel or by the
    plain form on the card."""
    parts = ll_ops.loglik_partition_sums(*args, p, kernel=kernel)
    parts = parts.cpu().numpy()
    return parts.sum(axis=2), parts


@pytest.mark.parametrize("m,n,c,ks,p", [
    (469, 180, 50, 1, 7),    # M % 4 != 0: bank rows staged by 4-byte copies
    (448, 34, 5, 5, 7),      # 16-byte copies; one partial tile
    (448, 180, 1000, 1, 4),  # above the staging bound: unstaged
    (450, 180, 5, 5, 1),     # two blocks of pairs side by side
    (450, 34, 5, 5, 1),
])
def test_loglik_terms_bit_equal_twin(cuda, m, n, c, ks, p):
    """One site of each partition carries weight 1, the others 0, so each
    float64 output is one float32 term widened: the kernel's terms equal
    the plain form's bit for bit, the padding pattern and the AF clamp
    edges included."""
    g0, g1, bank, col, _ = _loglik_operands(cuda, m, n, c, ks, 0, 30 + ks)
    rng = np.random.default_rng(31)
    for _ in range(3):
        sw = np.zeros(m, np.float32)
        sw[rng.integers(0, m // p, size=p) * p + np.arange(p)] = 1.0
        args = (g0, g1, bank, col, torch.from_numpy(sw).to(cuda))
        before = _kernels.launches["loglik"]
        _, got = _loglik_pair(args, p, True)
        assert _kernels.launches["loglik"] == before + 1
        _, want = _loglik_pair(args, p, False)
        assert _kernels.launches["loglik"] == before + 1
        assert np.isfinite(want).all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,ks", [(34, 5), (180, 1), (180, 5)])
@pytest.mark.parametrize("p", [1, 4, 7])
def test_loglik_sums_match_twin(cuda, n, ks, p):
    """Float64 sums over 2,100 sites (not a multiple of any tile), 14 of
    them padding, agree with the plain form's to 1e-12: the same terms,
    added in another order."""
    m = 2100
    for c in (5, 50, 1000):  # 1000 rows: above the staging bound
        args = _loglik_operands(cuda, m, n, c, ks, 14, 40 + c)
        assert ll_ops.loglik_geometry(n, ks, c, p)[5] == (c < 1000)
        for got, want in zip(_loglik_pair(args, p, True),
                             _loglik_pair(args, p, False)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_loglik_sums_are_deterministic(cuda, dtype):
    """Two launches on equal inputs give bit-identical sums."""
    args = _loglik_operands(cuda, 30001, 180, 50, 1, 7, 50)
    first = ll_ops.loglik_sums(*args, 1, dtype)
    for _ in range(3):
        assert torch.equal(ll_ops.loglik_sums(*args, 1, dtype), first)


@pytest.mark.parametrize("p", [1, 4])
def test_loglik_f32_sums_match_twin(cuda, p):
    """``--f32_sums``: float32 sums in the kernel's order against the plain
    form's, at the tolerances of the analyses' card-vs-CPU tests."""
    args = _loglik_operands(cuda, 4000, 40, 3, 3, 0, 60)
    got = ll_ops.loglik_partition_sums(*args, p, torch.float32)
    want = ll_ops.loglik_partition_sums(*args, p, torch.float32, kernel=False)
    for g, w in ((got.sum(dim=2), want.sum(dim=2)), (got, want)):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=1e-5, atol=2e-3)


def test_analyses_launch_loglik_on_the_card(cuda):
    """``leave_one_out`` launches ``loglik`` once a population and
    ``assignment_loglikelihoods`` once a call, by the launch count and, while
    a profiler records, by the counter ``loglik.launches``."""
    from torch.profiler import ProfilerActivity, profile

    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.obs.profiling import counters
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = _beagle(3000, 30, 25)
    popmap = population_map(beagle.sample_names,
                            [f"pop{i % 3}" for i in range(30)])
    cohort = to_device(beagle, make_runtime(cuda))
    ref = estimate_reference_af(beagle, popmap, cohort=cohort)

    def launched(fn):
        before = (_kernels.launches["loglik"],
                  counters().get("loglik.launches", 0))
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        return (_kernels.launches["loglik"] - before[0],
                counters().get("loglik.launches", 0) - before[1])

    assert launched(lambda: leave_one_out(
        beagle, ref.af, popmap, cohort=cohort,
        af_t_dev=ref.af_t_dev)) == (3, 3)
    assert launched(lambda: assignment_loglikelihoods(
        beagle, ref.af, cohort=cohort)) == (1, 1)
    assert launched(lambda: assignment_loglikelihoods(
        beagle, ref.af, cohort=cohort, num_partitions=4,
        f64_sums=False)) == (1, 1)


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
    EM kernel, no ``loglik`` and no ``ztables_*`` launched, equal
    iterations and AF to the kernels' run, and reference z-scores with
    equal loci and EM iterations."""
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.models.common import (
        to_device,
        upload_allele_depths,
    )
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.models.zscore import reference_z_scores
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = _beagle(3000, 30, 23)
    popmap = population_map(beagle.sample_names,
                            [f"pop{i % 3}" for i in range(30)])
    runs = {}
    for use_kernels in (False, True):
        _kernels.launches.clear()
        cohort = to_device(beagle, make_runtime(cuda, use_kernels=use_kernels))
        ref = estimate_reference_af(beagle, popmap, cohort=cohort)
        loo = leave_one_out(beagle, ref.af, popmap, cohort=cohort,
                            af_t_dev=ref.af_t_dev)
        runs[use_kernels] = (ref, loo, dict(_kernels.launches))
    plain, fused = runs[False], runs[True]
    assert not plain[2].get("em_chunk") and not plain[2].get("loo_chunk")
    assert not plain[2].get("loglik")
    assert fused[2]["em_chunk"] and fused[2]["loo_chunk"]
    assert fused[2]["loglik"] == 3
    assert plain[0].engine == "plain" and set(plain[1].engines) == {"plain"}
    np.testing.assert_array_equal(plain[0].iters, fused[0].iters)
    np.testing.assert_array_equal(plain[1].iters, fused[1].iters)
    np.testing.assert_allclose(plain[0].af, fused[0].af, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain[1].ll, fused[1].ll, rtol=1e-5, atol=2e-3)

    zbeagle, zpopmap, ad = _jittered_cohort(20_000, 30, 3, 25)
    zruns = {}
    for use_kernels in (False, True):
        _kernels.launches.clear()
        cohort = to_device(zbeagle,
                           make_runtime(cuda, use_kernels=use_kernels))
        z = reference_z_scores(zbeagle, upload_allele_depths(ad, cohort),
                               zpopmap, cohort=cohort)
        zruns[use_kernels] = (z, dict(_kernels.launches))
    (zp, zp_counts), (zf, zf_counts) = zruns[False], zruns[True]
    assert not any(zp_counts.get(k) for k in (
        "ztables_bin", "ztables_filter", "zloo_chunk", "sites_chunk",
        "zsums"))
    assert zf_counts["ztables_bin"] == zf_counts["ztables_filter"] == 1
    assert zf_counts["zloo_chunk"]
    assert zf_counts["zsums"] == 1  # one AF group of 30
    assert zp.engine == "plain" and zf.engine == "zloo_chunk"
    np.testing.assert_array_equal(zp.loci, zf.loci)
    np.testing.assert_array_equal(zp.em_iters, zf.em_iters)
    np.testing.assert_allclose(zp.z, zf.z, rtol=0, atol=1e-4)


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


def _jittered_cohort(m, n, k, seed):
    """A synthetic cohort with its allele depths, a fifth of its GL triples
    moved off the read counts' values (the site filter then drops some)."""
    from wgsassign_tpu_torch.io.beagle import BeagleData
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.io.synth import synth_cohort

    gl, labels, ad = synth_cohort(m, n, n_pops=k, seed=seed)
    rng = np.random.default_rng(seed + 100)
    g = np.concatenate([gl, 1.0 - gl.sum(axis=2, keepdims=True)], axis=2)
    jitter = rng.random((m, n)) < 0.2
    g = np.where(jitter[:, :, None],
                 g * np.exp(rng.normal(0.0, 0.1, g.shape)), g)
    gl = (g / g.sum(axis=2, keepdims=True))[:, :, :2].astype(np.float32)
    names = [f"Ind{i}" for i in range(n)]
    return (BeagleData(gl, names, [f"s{i}" for i in range(m)]),
            population_map(names, labels), ad)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_ztables_kernels_match_twins(cuda, dtype):
    """Both table passes, bit for bit: each chunk's sites are added in site
    order by the kernel's thread and by the twin's ``index_add_``."""
    from wgsassign_tpu_torch.ops.ztables import (
        combo_bins,
        combo_bins_twin,
        site_filter,
        site_filter_twin,
    )

    m, n, width, col0, b = 70_001, 40, 9, 3, 35
    rng = np.random.default_rng(21)
    ad = torch.from_numpy(rng.integers(0, width, (m, 2 * n))).to(dtype)
    g0, g1 = (torch.from_numpy(x) for x in _gls(m, n, 22))
    args = (col0, b, m - 5, width)
    dev = [t.to(cuda) for t in (ad, g0, g1)]
    before = _kernels.launches["ztables_bin"]
    part = combo_bins(*dev, *args)
    assert _kernels.launches["ztables_bin"] == before + 1
    want = combo_bins_twin(ad, g0, g1, *args)
    assert torch.equal(part.cpu(), want)
    sums = want.sum(0)
    keepc = (sums[..., 3] > 900).to(torch.uint8)
    mean = sums[..., :3] / sums[..., 3:].clamp(min=1.0)
    amax = mean.argmax(2)
    meanv = mean.gather(2, amax[..., None])[..., 0].contiguous()
    tabs = (keepc, amax.to(torch.uint8), meanv)
    mask = torch.zeros((b, m), dtype=torch.uint8)
    mask_d = mask.to(cuda)
    counts = site_filter(*dev, *args, *(t.to(cuda) for t in tabs), mask_d,
                         0.3)
    want = site_filter_twin(ad, g0, g1, *args, *tabs, mask, 0.3)
    assert 0 < int(mask.sum()) < b * m
    assert torch.equal(mask_d.cpu(), mask)
    assert torch.equal(counts.cpu(), want)


def test_device_tables_card_vs_cpu(cuda):
    """``build_tables`` on the card equals the CPU's: kept sites, combos,
    mean GLs, read probabilities, split tables and counts."""
    from wgsassign_tpu_torch.models.common import (
        to_device,
        upload_allele_depths,
    )
    from wgsassign_tpu_torch.models.zscore import build_tables
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle, _, ad = _jittered_cohort(50_000, 36, 3, 23)
    built = []
    for dev in (cuda, "cpu"):
        cohort = to_device(beagle, make_runtime(dev))
        built.append(build_tables(cohort, upload_allele_depths(ad, cohort),
                                  2, 33, 0, False))
    got, want = built
    for name in ("mask", "combos", "mean_gl", "read_probs",
                 "rows_by_depth"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    for name in ("n_rows", "s_local", "s_glob"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("single_read,structure,engine", [
    (False, "loo-structured", "zloo_chunk"),
    (True, "gathered", "sites_chunk")])
def test_reference_z_100k_card_vs_cpu(cuda, single_read, structure, engine):
    """Reference z-scores at 100,000 sites on the card against the CPU, in
    both EM structures: equal loci and EM iterations, z to atol 1e-4 (the
    EM kernels round as their twins do and both sides sum the z terms in
    float64, in other orders)."""
    from wgsassign_tpu_torch.models.common import (
        to_device,
        upload_allele_depths,
    )
    from wgsassign_tpu_torch.models.zscore import reference_z_scores
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle, popmap, ad = _jittered_cohort(100_000, 16, 2, 24)
    out = []
    for dev in (cuda, "cpu"):
        cohort = to_device(beagle, make_runtime(dev))
        out.append(reference_z_scores(
            beagle, upload_allele_depths(ad, cohort), popmap,
            cohort=cohort, single_read_threshold=single_read))
    got, want = out
    assert got.structure == want.structure == structure
    assert got.engine == engine
    np.testing.assert_array_equal(got.loci, want.loci)
    np.testing.assert_array_equal(got.em_iters, want.em_iters)
    assert np.isfinite(got.z).all()
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-4)


def test_gathered_z_scores_are_a_span_and_counted_on_the_card(
        cuda, monkeypatch):
    """On the card's kernel path the gathered z-score EM records the span
    ``wgsa.zscore.gather`` once an AF group (6, 6, 4), with device time, and
    the two gather counters at their hand counts (populations of 5 and 11:
    ``p_pad`` 10); the ``sites_chunk`` kernel is launched as often as the
    driver counts its chunks and their replays (``sites_chunk.launches``
    and ``.replays``)."""
    from torch.profiler import ProfilerActivity, profile

    import wgsassign_tpu_torch.models.zscore as zmod
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.models.common import (
        to_device,
        upload_allele_depths,
    )
    from wgsassign_tpu_torch.obs import profiling as prof
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle, _, ad = _jittered_cohort(100_000, 16, 2, 25)
    labels = np.repeat(["p0", "p1"], [5, 11])
    popmap = population_map(beagle.sample_names, list(labels))
    cohort = to_device(beagle, make_runtime(cuda))
    depths = upload_allele_depths(ad, cohort)
    monkeypatch.setattr(zmod, "AF_GROUP_MAX_INDS", 6)
    counts, spans = prof.counters(), prof.span_totals()
    launched = _kernels.launches["sites_chunk"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = zmod.reference_z_scores(beagle, depths, popmap, cohort=cohort,
                                      single_read_threshold=True,
                                      block_bytes=1)
    got = {k: v - counts.get(k, 0) for k, v in prof.counters().items()}
    after = prof.span_totals()

    def calls(name):
        return after[name]["calls"] - spans.get(name, {"calls": 0})["calls"]

    assert res.structure == "gathered" and res.engine == "sites_chunk"
    assert calls("wgsa.zscore.gather") == calls("wgsa.zscore.em") == 3
    assert after["wgsa.zscore.gather"]["device_s"] > 0
    assert got["sites_chunk.launches"] > 0
    runs = got["sites_chunk.launches"] + got.get("sites_chunk.replays", 0)
    assert _kernels.launches["sites_chunk"] - launched == runs
    others = np.where(labels == "p0", 4, 10)
    s_pad = 1 << (int(res.loci.max()) - 1).bit_length()
    assert got["zscore.gather_useful"] == int((others * res.loci).sum())
    assert got["zscore.gather_launched"] == 16 * 10 * s_pad


def _zsums_operands(dev, dtype, c, r, seed, nan_padding=False):
    """The z sums' kept-slot operands on ``dev``: five individuals (cohort
    columns 3-7 of 12) with 30,001, 29,000, 0, 17 and 20,000 kept slots of
    30,001 (kept sites ascending), ``dtype`` read counts of depth below
    ``c``, combo rows in ``[0, r)``, AF with ~10% at the clamp edges.
    Padded slots point at the last site, which no real slot keeps; with
    ``nan_padding`` its GLs and the padded slots' AF are NaN.  ``keep`` is
    the first S columns of a ``[G, S + 1]`` table, as the z-score driver
    slices its slot table."""
    from wgsassign_tpu_torch.ops.zscore_ops import ZSUMS_THREADS

    m, n, col0 = 40_000, 12, 3
    s_local = np.asarray([30_001, 29_000, 0, 17, 20_000])
    g, s = s_local.size, int(s_local.max())
    assert s % ZSUMS_THREADS  # a ragged last chunk
    rng = np.random.default_rng(seed)
    g0, g1 = _gls(m, n, seed)
    depth = rng.integers(0, c, (m, n))
    minor = rng.integers(0, depth + 1)
    counts = np.stack([depth - minor, minor], axis=2).reshape(m, 2 * n)
    keep = np.full((g, s + 1), m - 1, np.int64)
    a = rng.uniform(0.02, 0.98, (g, s)).astype(np.float32)
    edges = np.float32([1e-7, 1.0 - 1e-7, 1.0 / 60.0, 1.0 - 1.0 / 60.0])
    at_edge = rng.random((g, s)) < 0.1
    a[at_edge] = rng.choice(edges, size=int(at_edge.sum()))
    for b, k in enumerate(s_local):
        keep[b, :k] = np.sort(rng.choice(m - 1, k, replace=False))
        if nan_padding:
            a[b, k:] = np.nan
    if nan_padding:
        g0[m - 1], g1[m - 1] = np.nan, np.nan
    rbd = rng.integers(0, r, (g, c, c)).astype(np.int32)
    mean_gl = rng.dirichlet(np.ones(3), (g, r)).astype(np.float32)
    read_probs = rng.uniform(0.01, 1.0, (g, r, 3)).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (
        g0, g1, counts.astype(np.int64), keep, a, rbd, mean_gl, read_probs)]
    t[2] = t[2].to(dtype)
    return (*t[:3], col0, t[3][:, :s], t[4], s_local, *t[5:])


@pytest.mark.parametrize("check", ["f64", "f32", "repeat", "nan_padding",
                                   "kernel_false"])
@pytest.mark.parametrize("c,r", [
    (4, 12), (16, 256),  # staged tables, the terms in registers
    (32, 1024),          # staged tables, the terms formed twice
    (16, 2500),          # tables above the staging bound
    (40, 3000),          # above both: unstaged, the terms formed twice
])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_zsums_kernel_matches_twin(cuda, dtype, c, r, check):
    """The ``zsums`` kernel against its twin on the card: float64 sums to
    1e-12 (the same float32 terms, added in another order); float32 sums
    within float32 summation rounding; two launches bit-identical; NaN in
    the padded slots' AF and GLs leaves every sum as it was (no padded
    slot is read); ``kernel=False`` launches nothing and runs the twin,
    and the kernel's call counts one block, its grid's slots and the kept
    slots."""
    from torch.profiler import ProfilerActivity, profile

    from wgsassign_tpu_torch.obs.profiling import counters
    from wgsassign_tpu_torch.ops.zscore_ops import (
        ZSUMS_STAGE_BYTES,
        kept_slot_sums,
        zsums,
        zsums_geometry,
    )

    ops = _zsums_operands(cuda, dtype, c, r, 70 + c)
    chunk, n_chunks, smem, _ = zsums_geometry(5, 30_001, c, r)
    assert n_chunks > 1
    assert (smem > 0) == (4 * (c * c + 6 * r) <= ZSUMS_STAGE_BYTES)
    f64, f32 = torch.float64, torch.float32
    before = _kernels.launches["zsums"]
    got = zsums(*ops, f64)
    assert _kernels.launches["zsums"] == before + 1
    assert torch.isfinite(got).all()
    assert not got[:, 2].any()  # no kept slot
    if check == "f64":
        want = kept_slot_sums(*ops, f64, kernel=False)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    elif check == "f32":
        got32 = zsums(*ops, f32)
        want32 = kept_slot_sums(*ops, f32, kernel=False)
        assert got32.dtype == want32.dtype == f32
        torch.testing.assert_close(got32, want32, rtol=1e-5, atol=0)
        torch.testing.assert_close(got32.double(), got, rtol=1e-5, atol=0)
    elif check == "repeat":
        got32 = zsums(*ops, f32)
        for _ in range(2):
            assert torch.equal(zsums(*ops, f64), got)
            assert torch.equal(zsums(*ops, f32), got32)
    elif check == "nan_padding":
        nan_ops = _zsums_operands(cuda, dtype, c, r, 70 + c, nan_padding=True)
        assert torch.isnan(nan_ops[5]).any() and torch.isnan(nan_ops[0]).any()
        assert torch.equal(zsums(*nan_ops, f64), got)
    else:
        launched = _kernels.launches["zsums"]
        want = kept_slot_sums(*ops, f64, block=2, kernel=False)
        assert _kernels.launches["zsums"] == launched
        torch.testing.assert_close(want, got, rtol=1e-12, atol=0)
        names = ("zscore.blocks", "zscore.launched_slots",
                 "zscore.kept_slots")
        before = [counters().get(k, 0) for k in names]
        with profile(activities=[ProfilerActivity.CPU]):
            assert torch.equal(kept_slot_sums(*ops, f64), got)
        assert _kernels.launches["zsums"] == launched + 1
        assert [counters().get(k, 0) - b for k, b in zip(names, before)] == [
            1, 5 * n_chunks * chunk, 30_001 + 29_000 + 0 + 17 + 20_000]
