"""The port's Fisher information and effective sample sizes (``--ne_obs``)
against the JAX package's, on a synthetic 600 x 30 x 3 cohort.

Tolerances: rtol 1e-5, atol 1e-4 -- float32 member sums in another order
(the population matmul) and float64 against float32 site sums of
``ne_ind``; tighter than the 2e-4 the JAX package is held to against the
reference's goldens (tests/test_fisher.py, tests/test_cli.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.io.beagle import BeagleData
from wgsassign_tpu.io.ids import population_map
from wgsassign_tpu.io.synth import synth_cohort
from wgsassign_tpu.models.ne import (
    effective_sample_sizes as jax_effective_sample_sizes,
)
from wgsassign_tpu.ops.fisher import fisher_obs_pops as jax_fisher_obs_pops
from wgsassign_tpu_torch.models.common import from_jax_arrays, to_device
from wgsassign_tpu_torch.models.ne import effective_sample_sizes
from wgsassign_tpu_torch.ops.fisher import fisher_obs_pops
from wgsassign_tpu_torch.parallel.runtime import make_runtime

M, N, K = 600, 30, 3
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def cohort():
    gl, labels, _ = synth_cohort(M, N, n_pops=K, seed=4)
    names = [f"Ind{i}" for i in range(N)]
    beagle = BeagleData(gl, names, [f"s{j}" for j in range(M)])
    # clamped AFs, as the CLI passes the reference-AF step's output
    af = np.random.default_rng(14).uniform(
        0.05, 0.95, size=(M, K)).astype(np.float32)
    return beagle, af, population_map(names, labels)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fisher_obs_pops_matches_jax(cohort):
    beagle, af, popmap = cohort
    pad = 8
    g0 = np.concatenate([beagle.gl[:, :, 0], np.ones((pad, N), np.float32)])
    g1 = np.concatenate([beagle.gl[:, :, 1], np.zeros((pad, N), np.float32)])
    af_p = np.concatenate([af, np.full((pad, K), 0.5, np.float32)])
    sw = np.concatenate([np.ones(M, np.float32), np.zeros(pad, np.float32)])
    args = (g0, g1, af_p, popmap.membership, popmap.pop_index, sw)
    want = [np.asarray(x) for x in jax_fisher_obs_pops(*args, M)]
    got = fisher_obs_pops(*from_jax_arrays(*args, device="cpu"), M)
    assert got[2].dtype == torch.float64
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        _close(g.numpy()[:M], w[:M])
    _close(got[2].numpy(), want[2])


def test_effective_sample_sizes_match_jax(cohort):
    beagle, af, popmap = cohort
    want = jax_effective_sample_sizes(beagle, af, popmap)
    got = effective_sample_sizes(beagle, af, popmap,
                                 runtime=make_runtime("cpu"))
    for name in ("f_obs", "ne_obs", "ne_ind"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.float32 and g.shape == w.shape
        _close(g, w)
    assert got.f_obs.shape == (M, K) and got.ne_ind.shape == (N,)


@pytest.mark.parametrize("site_block", [64, 7, M + 100])
def test_site_blocks_match(cohort, site_block):
    """Blocked site passes match one block (as tests/test_fisher.py holds
    the JAX package's blocks), on a cohort padded past its real sites."""
    beagle, af, popmap = cohort
    c = to_device(beagle, make_runtime("cpu"), site_multiple=16)
    assert c.m_pad > M
    whole = effective_sample_sizes(beagle, af, popmap, cohort=c)
    blocked = effective_sample_sizes(beagle, af, popmap, cohort=c,
                                     site_block=site_block)
    np.testing.assert_allclose(blocked.f_obs, whole.f_obs, rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(blocked.ne_obs, whole.ne_obs, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(blocked.ne_ind, whole.ne_ind, rtol=1e-5,
                               atol=1e-6)


def test_fisher_is_minus_second_derivative(cohort):
    """Observed info equals -d2/dtheta2 of the per-site log-likelihood,
    summed over a population's members (torch autograd against the op)."""
    beagle, af, popmap = cohort
    res = effective_sample_sizes(beagle, af, popmap,
                                 runtime=make_runtime("cpu"))
    k = 1
    members = popmap.members_of(popmap.pops[k])
    for s in (0, 17, 311):
        g0 = torch.from_numpy(beagle.gl[s, members, 0]).double()
        g1 = torch.from_numpy(beagle.gl[s, members, 1]).double()

        def ll(th):
            return torch.log(g0 * (1 - th) ** 2 + g1 * 2 * th * (1 - th)
                             + (1 - g0 - g1) * th * th).sum()

        th = torch.tensor(float(af[s, k]), dtype=torch.float64)
        d2 = torch.autograd.functional.hessian(ll, th)
        np.testing.assert_allclose(res.f_obs[s, k], -float(d2), rtol=5e-3)
