"""The port's selected log-likelihoods against the JAX package's.

The JAX ``*_f64`` functions add float32 block partial sums in float64 on the
host; the port sums every float32 per-site term in float64 on the device.
The two round differently, so they agree to rtol 1e-5.  The float32-sum
forms are compared at the same tolerance.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.ops import loglik as jax_ll
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


def test_selected_f32_matches_jax():
    g0, g1, bank, col_idx, sw = _inputs()
    ref = np.asarray(jax_ll.assign_loglik_selected(g0, g1, bank, col_idx, sw))
    got = loglik.assign_loglik_selected(
        *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("p", [1, 4])
def test_selected_partitioned_f64_matches_jax(p):
    g0, g1, bank, col_idx, sw = _inputs()
    ll_ref, parts_ref = jax_ll.assign_loglik_selected_partitioned_f64(
        g0, g1, bank, col_idx, sw, p)
    ll, parts = loglik.assign_loglik_selected_partitioned_f64(
        *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"), p)
    assert parts.shape == (12, p, 3)
    np.testing.assert_allclose(ll, ll_ref, rtol=1e-5)
    np.testing.assert_allclose(parts, parts_ref, rtol=1e-5)


def test_selected_partitioned_f32_matches_jax():
    g0, g1, bank, col_idx, sw = _inputs()
    ll_ref, parts_ref = jax_ll.assign_loglik_selected_partitioned(
        g0, g1, bank, col_idx, sw, 4)
    ll, parts = loglik.assign_loglik_selected_partitioned(
        *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"), 4)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-5)
    np.testing.assert_allclose(parts.numpy(), np.asarray(parts_ref),
                               rtol=1e-5)


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
        loglik.assign_loglik_selected_partitioned_f64(
            *from_jax_arrays(g0, g1, bank, col_idx, sw, device="cpu"), 4)
