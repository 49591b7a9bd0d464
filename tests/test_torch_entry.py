"""The port's entry points (``wgsassign_tpu_torch/graft_entry.py``) against
the JAX package's (``__graft_entry__.py``) on the CPU.

- ``synthetic_problem`` gives the JAX hook's arrays from the same seed,
  exactly.
- ``entry("cpu")``'s forward step (``em_chunk``'s twin at T=1, then
  ``assign_loglik``) against ``jax.jit`` of the JAX entry's ``fn`` on the
  same arguments: ``f_new`` within atol 1e-6; the ``[N, K]`` log-likelihood
  panel, float32 sums over M sites in another order, within rtol 1e-5 and
  atol 2e-3 (the log-likelihood tolerance of the other port tests).
- ``dryrun_multichip(2, device="cpu")`` (two gloo ranks, then the CLI on two
  ranks) returns results equal to one rank within the tolerances it states,
  and equal to the JAX functions run directly on the whole inputs: equal
  iterations, AF panels within atol 1e-6, log-likelihood, Fisher and Ne
  sums within rtol 1e-5 and atol 1e-4.  The JAX ``dryrun_multichip`` is not
  called here: it rebuilds the JAX backend.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

import __graft_entry__ as jentry
from wgsassign_tpu.ops.emmaf import (
    clamp_af,
    em_maf_loo_group,
    em_maf_loo_subset,
    em_maf_pops,
)
from wgsassign_tpu.ops.fisher import fisher_obs_pops
from wgsassign_tpu.ops.loglik import assign_loglik
from wgsassign_tpu_torch import graft_entry as tentry
from wgsassign_tpu_torch.parallel.runtime import make_runtime

F_ATOL = 1e-6
LL_RTOL, LL_ATOL = 1e-5, 2e-3
SUM_RTOL, SUM_ATOL = 1e-5, 1e-4
WORLD = 2


@pytest.mark.parametrize("m,n,k,seed", [
    (1024, 64, 4, 0), (32, 12, 3, 1), (48, 12, 3, 1), (7, 5, 2, 9)])
def test_synthetic_problem_matches_jax(m, n, k, seed):
    got = tentry.synthetic_problem(m, n, k, seed=seed)
    want = jentry._synthetic_problem(m, n, k, seed=seed)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_entry_args_are_the_jax_entrys():
    module, args = tentry.entry("cpu")
    _, want = jentry.entry()
    assert isinstance(module, torch.nn.Module)
    for got, w in zip(args, want, strict=True):
        assert got.device.type == "cpu"
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


def _jax_forward(args):
    fn, _ = jentry.entry()
    f_new, ll = jax.jit(fn)(*args)
    return np.asarray(f_new), np.asarray(ll)


def _check_forward(module, args):
    f_new, ll = module(*(torch.from_numpy(a) for a in args))
    want_f, want_ll = _jax_forward(args)
    assert f_new.shape == want_f.shape and ll.shape == want_ll.shape
    assert f_new.dtype == ll.dtype == torch.float32
    np.testing.assert_allclose(f_new.numpy(), want_f, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(ll.numpy(), want_ll, rtol=LL_RTOL,
                               atol=LL_ATOL)


def test_entry_cpu_matches_jax_entry():
    module, args = tentry.entry("cpu")
    _check_forward(module, tuple(a.numpy() for a in args))


@pytest.mark.parametrize("m,n,k", [(100, 9, 2), (257, 40, 5), (64, 12, 1)])
def test_forward_step_is_shape_generic(m, n, k):
    g0, g1, membership, pop_index, site_weight = tentry.synthetic_problem(
        m, n, k, seed=m)
    f0 = np.random.default_rng(k).uniform(0.05, 0.95, (m, k)).astype(
        np.float32)
    site_weight[m // 3] = 0.0
    _check_forward(tentry.ForwardStep(),
                   (g0, g1, membership, pop_index, f0, site_weight))


def test_entry_needs_cuda_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tentry.entry()


@pytest.fixture(scope="module")
def dryrun():
    return tentry.dryrun_multichip(WORLD, device="cpu")


@pytest.fixture(scope="module")
def problem():
    return tentry.synthetic_problem(tentry.DRY_SITES_PER_RANK * WORLD,
                                    tentry.DRY_N, tentry.DRY_K, seed=1)


@pytest.fixture(scope="module")
def jax_results(problem):
    g0, g1, membership, pop_index, site_weight = problem
    m = g0.shape[0]
    f_raw, iters, converged = em_maf_pops(
        g0, g1, membership, pop_index, site_weight, m, tentry.DRY_EM_ITERS,
        0.0)
    f = clamp_af(f_raw, membership.sum(axis=0))
    f_obs, ne_obs, ne_ind = fisher_obs_pops(g0, g1, f, membership,
                                            pop_index, site_weight, m)
    members = np.flatnonzero(pop_index == 0)
    g0p = np.ascontiguousarray(g0[:, members].T)
    g1p = np.ascontiguousarray(g1[:, members].T)
    f_loo, loo_iters, _ = em_maf_loo_group(g0p, g1p, site_weight, m,
                                           tentry.DRY_LOO_ITERS, 0.0)
    b = tentry.DRY_SUBSET_B
    sw_z = np.ones((b, m), np.float32)
    sw_z[:, m // 2:] = 0.0
    f_z, z_iters, _ = em_maf_loo_subset(
        g0p, g1p, np.arange(b, dtype=np.int32), sw_z,
        np.full(b, float(m // 2), np.float32), tentry.DRY_LOO_ITERS, 0.0)
    out = dict(f_raw=f_raw, iters=iters, converged=converged, f=f,
               ll=assign_loglik(g0, g1, f, site_weight), f_obs=f_obs,
               ne_obs=ne_obs, ne_ind=ne_ind, f_loo=f_loo,
               loo_iters=loo_iters, f_z=f_z, z_iters=z_iters)
    return {key: np.asarray(v) for key, v in out.items()}


def test_dryrun_ranks_and_backend(dryrun):
    assert str(dryrun["backend"]) == "gloo"
    assert dryrun["devices"].tolist() == ["cpu"] * WORLD


def test_dryrun_matches_one_rank(dryrun, problem):
    want = tentry._dryrun_step(make_runtime("cpu"), problem)
    tentry._check_against_one_rank(dryrun, want)
    for key in ("f_raw", "ll", "f_loo", "f_z"):
        assert dryrun[key].shape == want[key].shape


@pytest.mark.parametrize("key", ["iters", "converged", "loo_iters",
                                 "z_iters"])
def test_dryrun_iterations_match_jax(dryrun, jax_results, key):
    np.testing.assert_array_equal(dryrun[key], jax_results[key])


@pytest.mark.parametrize("key", ["f_raw", "f", "f_loo", "f_z"])
def test_dryrun_af_matches_jax(dryrun, jax_results, key):
    assert dryrun[key].shape == jax_results[key].shape
    np.testing.assert_allclose(dryrun[key], jax_results[key], rtol=0,
                               atol=F_ATOL)


@pytest.mark.parametrize("key", ["ll", "f_obs", "ne_obs", "ne_ind"])
def test_dryrun_sums_match_jax(dryrun, jax_results, key):
    assert dryrun[key].shape == jax_results[key].shape
    np.testing.assert_allclose(dryrun[key], jax_results[key], rtol=SUM_RTOL,
                               atol=SUM_ATOL)


@pytest.mark.parametrize("n", [0, -1])
def test_dryrun_needs_a_rank(n):
    with pytest.raises(ValueError, match="at least one rank"):
        tentry.dryrun_multichip(n, device="cpu")


def test_a_failed_rank_fails_the_dryrun(tmp_path):
    """Rank 0 fails after the collectives (its result file cannot be
    written) while rank 1 waits in the last barrier: the call raises at
    once, it does not wait out the collective time limit."""
    from wgsassign_tpu_torch.parallel.runtime import run_local_ranks

    with pytest.raises(RuntimeError, match=r"rank\(s\) failed .*\{0: 1"):
        run_local_ranks(tentry._dryrun_rank, WORLD, "cpu",
                        str(tmp_path / "missing" / "rank0.npz"),
                        what="dry run")
