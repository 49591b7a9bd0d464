"""CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here needs an NVIDIA GPU and nvcc, and skips without them (the
kernels have no CPU mode).  This file imports neither jax nor the JAX
package's device code, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the kernels round op for op like the twins (-fmad=false, IEEE
division, members summed in the same order), so ``ft`` agrees to atol 1e-6
and ``sq`` -- summed over sites in another order (warp shuffles, blocks) --
to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.ops.em_chunk import em_chunk, em_chunk_twin
from wgsassign_tpu_torch.ops.fused_em import (
    em_maf_loo_group_fused,
    em_maf_pops_fused,
)
from wgsassign_tpu_torch.ops.loo_chunk import loo_chunk, loo_chunk_twin

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
@pytest.mark.parametrize("m,n,k", [
    (1000, 37, 3),    # resident tile, ragged last block
    (300, 3000, 4),   # wider than shared memory: staged per iteration
])
def test_em_chunk_kernel_matches_twin(cuda, fast_math, m, n, k):
    g0, g1 = _gls(m, n, 1)
    rng = np.random.default_rng(2)
    ft = rng.uniform(0.05, 0.95, size=(k, m)).astype(np.float32)
    pop = (np.arange(n) % k).astype(np.int32)
    inv = (1.0 / np.bincount(pop, minlength=k)).astype(np.float32)
    lim = np.asarray([7, 3, 0, 7][:k], np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (g0, g1, ft, pop, inv, lim)]
    before = _kernels.launches["em_chunk"]
    f_k, sq_k = em_chunk(*args, 7, fast_math=fast_math)
    assert _kernels.launches["em_chunk"] == before + 1
    f_t, sq_t = em_chunk_twin(*args, 7, fast_math=fast_math)
    torch.cuda.synchronize()
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-6)
    torch.testing.assert_close(sq_k, sq_t, rtol=1e-5, atol=0)


@pytest.mark.parametrize("fast_math", [True, False])
def test_loo_chunk_kernel_matches_twin(cuda, fast_math):
    g0p, g1p = _gls(16, 1000, 3)
    g0p[11:], g1p[11:] = 1.0, 0.0
    ft = np.random.default_rng(4).uniform(
        0.05, 0.95, size=(16, 1000)).astype(np.float32)
    lim = np.asarray([6, 2, 0, 6, 6, 1, 6, 6, 6, 6, 6, 0, 0, 0, 0, 0],
                     np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (g0p, g1p, ft, lim)]
    before = _kernels.launches["loo_chunk"]
    f_k, sq_k = loo_chunk(*args, 11, 6, fast_math=fast_math)
    assert _kernels.launches["loo_chunk"] == before + 1
    f_t, sq_t = loo_chunk_twin(*args, 11, 6, fast_math=fast_math)
    torch.cuda.synchronize()
    torch.testing.assert_close(f_k, f_t, rtol=0, atol=1e-6)
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
