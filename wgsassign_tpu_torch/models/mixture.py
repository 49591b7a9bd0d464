"""Mixture-proportion estimation (``--get_em_mix`` / ``--get_mcmc_mix``).

A copy of ``wgsassign_tpu/models/mixture.py``, which cannot be imported
without jax (its package ``__init__`` loads the device modules).  These are
small ``[N, K]`` host computations in float64 numpy in the JAX package too;
the heavy upstream work (the log-likelihood matrix) is the device pipeline.

Reference semantics (mixture.py:10-39): per "harvest" population, EM on the
individual x source log-likelihood matrix -- responsibilities
``R = exp(LL) * pi`` row-normalised, ``pi = colmean(R)``, a fixed number of
iterations with no convergence check.  ``stable=True`` runs the same
fixed-point map in log space (log-sum-exp), which matches the raw version
whenever the raw version is finite and keeps working when ``exp``
underflows.

The MCMC variant (the reference's crashes, mixture.py:41-77) draws, per
iteration, per-individual multinomial source assignments from the
responsibilities, then ``pi ~ Dirichlet(counts + 0.001)``; the estimate is
the posterior mean over post-burn-in draws, or the last draw.  It draws
from ``np.random.default_rng(seed)`` in the same order as the JAX package,
so ``--mcmc_seed`` gives the same output from both packages; a torch
generator would draw other numbers from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class MixtureResult:
    harvest_pops: np.ndarray  # [H]
    pi: np.ndarray            # float64 [H, K]


def _responsibilities_raw(ll, pi):
    lik = np.exp(ll)
    r = lik * pi[None, :]
    return r / r.sum(axis=1, keepdims=True)


def _responsibilities_stable(ll, pi):
    with np.errstate(divide="ignore"):
        logr = ll + np.log(pi)[None, :]
    logr -= logr.max(axis=1, keepdims=True)
    r = np.exp(logr)
    return r / r.sum(axis=1, keepdims=True)


def em_mixture(
    ll_mat: np.ndarray,
    harvest_labels,
    n_iter: int = 200,
    stable: bool = False,
) -> MixtureResult:
    ll_mat = np.asarray(ll_mat, np.float64)
    labels = np.asarray(harvest_labels, dtype=str)
    harvest = np.unique(labels)
    k = ll_mat.shape[1]
    resp = _responsibilities_stable if stable else _responsibilities_raw
    pi_out = np.empty((len(harvest), k), dtype=np.float64)
    for h, pop in enumerate(harvest):
        rows = np.flatnonzero(labels == pop)
        ll = ll_mat[rows]
        pi = np.full(k, 1.0 / k)
        for _ in range(n_iter):
            pi = resp(ll, pi).sum(axis=0) / len(rows)
        pi_out[h] = pi
    return MixtureResult(harvest_pops=harvest, pi=pi_out)


def mcmc_mixture(
    ll_mat: np.ndarray,
    harvest_labels,
    n_iter: int = 200,
    seed: Optional[int] = None,
    burn_frac: float = 0.5,
    posterior_mean: bool = True,
    stable: bool = True,
) -> MixtureResult:
    ll_mat = np.asarray(ll_mat, np.float64)
    labels = np.asarray(harvest_labels, dtype=str)
    harvest = np.unique(labels)
    k = ll_mat.shape[1]
    resp = _responsibilities_stable if stable else _responsibilities_raw
    rng = np.random.default_rng(seed)
    pi_out = np.empty((len(harvest), k), dtype=np.float64)
    burn = int(n_iter * burn_frac)
    for h, pop in enumerate(harvest):
        rows = np.flatnonzero(labels == pop)
        ll = ll_mat[rows]
        pi = np.full(k, 1.0 / k)
        draws = np.empty((n_iter, k), dtype=np.float64)
        for j in range(n_iter):
            r = resp(ll, pi)
            assignments = np.array([rng.multinomial(1, p) for p in r])
            counts = assignments.sum(axis=0) + 0.001
            pi = rng.dirichlet(counts)
            draws[j] = pi
        pi_out[h] = draws[burn:].mean(axis=0) if posterior_mean else draws[-1]
    return MixtureResult(harvest_pops=harvest, pi=pi_out)


def format_mixture_output(result: MixtureResult) -> np.ndarray:
    """Reference output layout: harvest-pop name column + float32 proportion
    columns, stacked as strings (mixture.py:38)."""
    h = len(result.harvest_pops)
    return np.hstack(
        [
            np.asarray(result.harvest_pops).reshape(h, 1),
            result.pi.astype(np.float32).astype(str),
        ]
    )
