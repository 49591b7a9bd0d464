"""The plain reference against the port's CPU path at a tiny size (this
test imports the port; ``portbench/reference.py`` does not)."""

import types

import numpy as np
import pytest
import torch

from portbench import cohort, harness, reference

M, SIZES = 3000, (5, 7, 6)
N, K = sum(SIZES), len(SIZES)


@pytest.fixture(scope="module")
def planes():
    gen = cohort.make_generator(2**31 + 3, "cpu")
    af = cohort.population_af(gen, M, K, 0.05, "cpu")
    # unequal populations, interleaved, so that foreign columns read many
    # members' leave-one-out AF
    pop = np.random.default_rng(0).permutation(cohort.population_index(SIZES))
    g0, g1 = cohort.genotype_likelihoods(gen, af, pop, 2.0, 0.01)
    return g0, g1, pop, af


@pytest.fixture(scope="module")
def port(planes):
    from wgsassign_tpu_torch.io.ids import population_map
    from wgsassign_tpu_torch.models.common import DeviceCohort
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    g0, g1, pop, _ = planes
    rt = make_runtime("cpu")
    coh = DeviceCohort(g0=g0, g1=g1, site_weight=torch.ones(M), m_real=M,
                       runtime=rt)
    popmap = population_map([f"i{i}" for i in range(N)],
                            [f"pop{p:02d}" for p in pop])
    stub = types.SimpleNamespace(n_inds=N)
    res = estimate_reference_af(stub, popmap, 200, 1e-4, cohort=coh)
    loo = leave_one_out(stub, res.af, popmap, 200, 1e-4, cohort=coh,
                        af_t_dev=res.af_t_dev)
    return res, loo


def test_reference_af_matches_port(planes, port):
    g0, g1, pop, _ = planes
    af, iters = reference.reference_af(g0, g1, pop, K, 200, 1e-4)
    res, _ = port
    np.testing.assert_array_equal(iters, res.iters)
    np.testing.assert_allclose(af.numpy(), res.af, rtol=0, atol=2e-6)


def test_loo_matches_port(planes, port):
    g0, g1, pop, _ = planes
    af, _ = reference.reference_af(g0, g1, pop, K, 200, 1e-4)
    _, loo = port
    for p in range(K):
        members = np.flatnonzero(pop == p)
        f, its = reference.loo_em(g0[:, members].t().contiguous(),
                                  g1[:, members].t().contiguous(), 200, 1e-4)
        np.testing.assert_array_equal(its, loo.iters[members])
        lo = float(np.float32(1 / (2 * len(members))))
        bank = torch.cat([f.clamp(lo, 1 - lo), af[:, p][None]])
        ll = reference.banked_loglik(g0, g1, bank,
                                     reference.loo_bank_rows(pop, p))
        assert harness.ulps(loo.ll[:, p], ll.numpy()) <= 2.0


def test_loo_bank_rows_follow_the_in_place_write():
    pop = np.array([1, 0, 1, 0, 0, 1])
    # column 0: nobody before individual 1, then members 1, 3, 4 in turn
    assert reference.loo_bank_rows(pop, 0).tolist() == [3, 0, 0, 1, 2, 2]
    assert reference.loo_bank_rows(pop, 1).tolist() == [0, 0, 1, 1, 1, 2]


def test_assignment_matches_port(planes):
    from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods
    from wgsassign_tpu_torch.models.common import DeviceCohort
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    g0, g1, _, af = planes
    panel = cohort.clamp_panel(af, [30, 42, 32]).numpy()
    coh = DeviceCohort(g0=g0, g1=g1, site_weight=torch.ones(M), m_real=M,
                       runtime=make_runtime("cpu"))
    got = assignment_loglikelihoods(None, panel, cohort=coh)
    want = reference.assignment_loglik(g0, g1, torch.from_numpy(panel))
    assert harness.ulps(got, want.numpy()) <= 1.0
