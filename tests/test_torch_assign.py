"""The port's assignment log-likelihoods (``--get_pop_like``) against the
JAX package's, on a synthetic 600 x 30 x 3 cohort.

Tolerances: rtol 1e-5, atol 2e-3 and identical argmax, as
tests/test_cli.py holds the JAX CLI's log-likelihoods.  The JAX ``*_f64``
forms add float32 block partials in float64 on the host; the port sums
every float32 per-site term in float64 on the device; the float32 sums
reduce in another order.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.io.beagle import BeagleData
from wgsassign_tpu.io.synth import synth_cohort
from wgsassign_tpu.models.assign import (
    assignment_loglikelihoods as jax_assignment_loglikelihoods,
)
from wgsassign_tpu.ops import loglik as jax_ll
from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods
from wgsassign_tpu_torch.models.common import from_jax_arrays
from wgsassign_tpu_torch.ops import loglik
from wgsassign_tpu_torch.parallel.runtime import make_runtime

M, N, K, PAD = 600, 30, 3, 24
RTOL, ATOL = 1e-5, 2e-3


def _beagle(seed=0):
    gl, _, _ = synth_cohort(M, N, n_pops=K, seed=seed)
    af = np.random.default_rng(seed + 10).uniform(
        0.02, 0.98, size=(M, K)).astype(np.float32)
    return BeagleData(gl, [f"Ind{i}" for i in range(N)],
                      [f"s{j}" for j in range(M)]), af


def _op_inputs():
    """GL planes, AF and site weights with PAD padded sites (the (1, 0)
    GL pattern, AF 0.5, weight 0), as the cohorts hold them."""
    beagle, af = _beagle()
    g0 = np.concatenate([beagle.gl[:, :, 0], np.ones((PAD, N), np.float32)])
    g1 = np.concatenate([beagle.gl[:, :, 1], np.zeros((PAD, N), np.float32)])
    af = np.concatenate([af, np.full((PAD, K), 0.5, np.float32)])
    sw = np.concatenate([np.ones(M, np.float32), np.zeros(PAD, np.float32)])
    return g0, g1, af, sw


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_assign_ops_match_jax(p, dtype):
    """The one entry over ``af.T`` against the JAX package's unselected
    forms: ``[N, K]`` at one partition, ``[P, N, K]`` at several."""
    g0, g1, af, sw = _op_inputs()
    name = "assign_loglik" + ("_partitioned" if p > 1 else "")
    jax_form = getattr(jax_ll, name + ("_f64" if dtype == "float64" else ""))
    want = np.asarray(jax_form(g0, g1, af, sw, *([p] if p > 1 else [])))
    t = from_jax_arrays(g0, g1, af, sw, device="cpu")
    got = loglik.loglik_partition_sums(
        t[0], t[1], *loglik.identity_columns(N, t[2]), t[3], p,
        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (N, K, p)
    got = got.permute(2, 0, 1).numpy()  # [P, N, K]
    want = want.reshape(p, N, K)
    _close(got, want)
    np.testing.assert_array_equal(got.sum(0).argmax(1), want.sum(0).argmax(1))


def test_unselected_form_is_the_selected_one_over_af_t():
    """``assign_loglik_f64`` is the selected form with col_idx[i, k] = k."""
    g0, g1, af, sw = _op_inputs()
    t = from_jax_arrays(g0, g1, af, sw, device="cpu")
    col_idx = torch.arange(K).repeat(N, 1)
    np.testing.assert_array_equal(
        loglik.assign_loglik_f64(*t),
        loglik.assign_loglik_selected_f64(t[0], t[1], t[2].t().contiguous(),
                                          col_idx, t[3]))


@pytest.mark.parametrize("f64_sums", [True, False])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_assignment_loglikelihoods_match_jax(p, f64_sums):
    beagle, af = _beagle(seed=3)
    want = jax_assignment_loglikelihoods(beagle, af, num_partitions=p,
                                         f64_sums=f64_sums)
    got = assignment_loglikelihoods(beagle, af, runtime=make_runtime("cpu"),
                                    num_partitions=p, f64_sums=f64_sums)
    if p == 1:
        want, got = (want, None), (got, None)
    ll, parts = got
    assert ll.dtype == np.float32 and ll.shape == (N, K)
    _close(ll, want[0])
    np.testing.assert_array_equal(ll.argmax(1), want[0].argmax(1))
    if p > 1:
        assert parts.dtype == np.float32 and parts.shape == (N * p, K)
        _close(parts, want[1])
        # partition q of individual i is row i * P + q: the sites s % P == q
        a = af[:, 0]
        g0, g1 = beagle.gl[:, 0, 0], beagle.gl[:, 0, 1]
        site_ll = np.log(g0 * (1 - a) ** 2 + g1 * 2 * a * (1 - a)
                         + (1 - g0 - g1) * a * a)
        for q in range(p):
            _close(parts[q, 0], site_ll[q::p].sum(dtype=np.float64))


def _malformed():
    """The JAX package's sanitizer case (tests/test_assign.py): one GL
    triple with g0 + g1 > 1 where the AF makes its likelihood negative."""
    rng = np.random.default_rng(5)
    m, n, k = 32, 4, 2
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    gl = np.ascontiguousarray(raw[:, :, :2])
    af = rng.uniform(0.1, 0.9, size=(m, k)).astype(np.float32)
    names = ([f"I{i}" for i in range(n)], [f"s{j}" for j in range(m)])
    ok = BeagleData(gl.copy(), *names)
    bad_gl = gl.copy()
    bad_gl[3, 1] = (0.9, 0.9)  # g2 = 1 - 1.8 < 0
    af[3, 0] = 0.9  # likelihood 0.9(1-a)^2 + 1.8a(1-a) - 0.8a^2 < 0 there
    return ok, BeagleData(bad_gl, *names), af


def test_debug_checks_catch_malformed_gl():
    ok, bad, af = _malformed()
    rt = make_runtime("cpu", debug_checks=True)
    assert np.isfinite(assignment_loglikelihoods(ok, af, runtime=rt)).all()
    with pytest.raises(ValueError, match="non-positive assignment"):
        assignment_loglikelihoods(bad, af, runtime=rt)
    # without the checks the malformed cell folds into a non-finite sum
    ll = assignment_loglikelihoods(bad, af, runtime=make_runtime("cpu"))
    assert not np.isfinite(ll[1, 0])


def test_sanitizer_counts_cells_across_individual_blocks(monkeypatch):
    """The count is the same whatever the individual blocking."""
    _, bad, af = _malformed()
    counts = []
    for block in (loglik.BLOCK_ELEMENTS, 2 * 32):  # one block; 1 individual
        monkeypatch.setattr(loglik, "BLOCK_ELEMENTS", block)
        t = from_jax_arrays(bad.gl[:, :, 0], bad.gl[:, :, 1], af,
                            np.ones(32, np.float32), device="cpu")
        with pytest.raises(ValueError) as info:
            loglik.check_loglik_inputs(*t)
        counts.append(str(info.value).split(" cells")[0])
    assert counts[0] == counts[1]
    # a padded (weight 0) site with a malformed triple is not counted
    sw = np.ones(32, np.float32)
    sw[3] = 0.0
    loglik.check_loglik_inputs(*from_jax_arrays(
        bad.gl[:, :, 0], bad.gl[:, :, 1], af, sw, device="cpu"))
