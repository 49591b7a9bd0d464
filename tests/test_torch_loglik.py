"""The port's selected log-likelihoods against the JAX package's.

The JAX ``*_f64`` functions add float32 block partial sums in float64 on the
host; the port sums every float32 per-site term in float64 on the device.
The two round differently, so they agree to rtol 1e-5.  The float32 sums
are compared at the same tolerance.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.ops import loglik as jax_ll
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.models.common import from_jax_arrays
from wgsassign_tpu_torch.ops import loglik


def _inputs(m=240, n=12, c=5, k=3, pad=16, seed=8):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    g0, g1 = raw[:, :, 0].copy(), raw[:, :, 1].copy()
    g0[m - pad:], g1[m - pad:] = 1.0, 0.0
    bank = rng.uniform(0.02, 0.98, size=(c, m)).astype(np.float32)
    col_idx = rng.integers(0, c, size=(n, k)).astype(np.int32)
    sw = np.ones(m, np.float32)
    sw[m - pad:] = 0.0
    return g0, g1, bank, col_idx, sw


def test_site_loglik_matches_jax():
    g0, g1, bank, _, _ = _inputs()
    a = bank[0][:, None]
    np.testing.assert_allclose(
        loglik.site_loglik(*from_jax_arrays(g0, g1, a, device="cpu")).numpy(),
        np.asarray(jax_ll.site_loglik(g0, g1, a)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_selected_f64_matches_jax(k):
    g0, g1, bank, col_idx, sw = _inputs(k=k)
    ref = jax_ll.assign_loglik_selected_f64(g0, g1, bank, col_idx, sw)
    got = loglik.assign_loglik_selected_f64(
        *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"))
    assert got.dtype == np.float64 and got.shape == (12, k)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p", [1, 4])
def test_partition_sums_match_jax(p, dtype):
    """The one entry against the JAX package's partitioned selected forms,
    in float32 and float64 sums, with and without partitions."""
    g0, g1, bank, col_idx, sw = _inputs()
    jax_form = getattr(jax_ll, "assign_loglik_selected_partitioned"
                       + ("_f64" if dtype == "float64" else ""))
    ll_ref, parts_ref = jax_form(g0, g1, bank, col_idx, sw, p)
    got = loglik.loglik_partition_sums(
        *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"), p,
        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (12, 3, p)
    np.testing.assert_allclose(got.sum(dim=2).numpy(), np.asarray(ll_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(got.permute(0, 2, 1).numpy(),
                               np.asarray(parts_ref), rtol=1e-5)


def test_individual_blocks_do_not_change_sums(monkeypatch):
    """Blocking over individuals (the memory bound) leaves every sum as
    it is: each individual's sites are summed in one piece either way."""
    g0, g1, bank, col_idx, sw = _inputs()
    args = from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu")
    whole = loglik.assign_loglik_selected_f64(*args)
    monkeypatch.setattr(loglik, "BLOCK_ELEMENTS", 3 * 240 * 5)
    np.testing.assert_array_equal(loglik.assign_loglik_selected_f64(*args),
                                  whole)


def test_partitions_need_a_padded_site_axis():
    g0, g1, bank, col_idx, sw = _inputs(m=241, pad=1)
    with pytest.raises(ValueError, match="multiple of num_partitions"):
        loglik.loglik_partition_sums(
            *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"), 4)


@pytest.mark.parametrize("n,ks,c,p,want", [
    # the benchmark's shapes: leave-one-out (a mini-bank of 49 + 1 rows)
    # and assignment (34 individuals against K = 5 columns)
    (180, 1, 50, 1, (4, 180, 32, 180, 8 * (2 * 32 * 180 + 32 + 50 * 36),
                     True)),
    (34, 5, 5, 1, (2, 170, 64, 34, 8 * (2 * 64 * 34 + 64 + 5 * 68), True)),
    (1, 1, 1, 1, (64, 1, 64, 1, 8 * (2 * 64 + 64 + 68), True)),
    # a bank above the staging bound: no room beside a tile of 16 sites
    (180, 1, 2000, 1, (4, 180, 40, 180, 8 * (2 * 40 * 180 + 40), False)),
    # more pairs than a block takes: 48 pairs (11 individuals) a block
    (180, 5, 50, 16, (16, 48, 64, 11, 8 * (2 * 64 * 11 + 64 + 50 * 68),
                      True)),
    (180, 1, 50, 7, (7, 109, 28, 110, 8 * (2 * 28 * 110 + 28 + 50 * 32),
                     True)),
    (2000, 5, 5, 1, (1, 512, 64, 104, 8 * (2 * 64 * 104 + 64 + 5 * 68),
                     True)),
])
def test_loglik_geometry(n, ks, c, p, want):
    """The kernel's launch shape: rows and tiles multiples of the partition
    count, at most 768 threads, tiles of whole 16-byte copies, the two
    staged buffers within shared memory (within the staging budget where a
    tile of 16 sites leaves room for the bank rows), and every block's
    individuals within the buffers' ``nb``."""
    got = loglik.loglik_geometry(n, ks, c, p)
    assert got == want
    rows, width, tile, nb, smem, staged = got
    assert rows % p == 0 and rows * width <= loglik.LOGLIK_MAX_THREADS
    assert width <= n * ks and tile % 4 == 0 and tile % p == 0
    assert smem <= (loglik.LOGLIK_STAGE_BYTES if staged or p == 1
                    else _kernels.SMEM_LIMIT)
    q = n * ks
    for lo in range(0, q, width):
        first, last = lo // ks, (min(lo + width, q) - 1) // ks
        assert last - first + 1 <= nb


def test_loglik_staging_bound_at_the_loo_shape():
    """At 180 individuals and one partition the bank rows of a population of
    436 (437 rows) are staged beside a tile of 16 sites; a larger bank is
    read from global memory, beside a longer tile."""
    assert loglik.loglik_geometry(180, 1, 437, 1)[2:4] == (16, 180)
    assert loglik.loglik_geometry(180, 1, 437, 1)[5]
    assert loglik.loglik_geometry(180, 1, 438, 1)[2] == 40
    assert not loglik.loglik_geometry(180, 1, 438, 1)[5]


@pytest.mark.parametrize("args", [(0, 1, 5, 1), (4, 1, 0, 1),
                                  (4, 1, 5, 0), (4, 1, 5, 1025)])
def test_loglik_geometry_rejects_empty_shapes(args):
    with pytest.raises(ValueError, match="no launch"):
        loglik.loglik_geometry(*args)


def test_loglik_kernel_wrapper_refuses_cpu_tensors():
    g0, g1, bank, col_idx, sw = from_jax_arrays(*_inputs(), device="cpu")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        loglik.loglik_sums(g0, g1, bank, col_idx, sw, 1, torch.float64)


@pytest.mark.parametrize("p", [1, 4])
def test_cpu_tensors_take_the_plain_form(p):
    """On the CPU ``kernel=True`` runs the blocked form, bit for bit, and
    launches nothing."""
    args = from_jax_arrays(*_inputs(), device="cpu")
    before = dict(_kernels.launches)
    got = loglik.loglik_partition_sums(*args, p)
    want = loglik.loglik_partition_sums(*args, p, kernel=False)
    assert torch.equal(got, want)
    assert dict(_kernels.launches) == before
