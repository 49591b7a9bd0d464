"""The port's z-scores on the CPU against the plain reference of
``tests/zscore_reference.py`` (one individual at a time, its EM gathered
onto its kept sites), in both modes, with and without
``single_read_threshold``, at 3,000 sites x 24 individuals x 3 populations.
A fifth of the GL triples are jittered away from the read counts' values,
so the site filter drops sites and the combo means are not exact.

Tolerances: loci and EM iterations equal.  z to atol 1e-4 and the three
sums to rtol 1e-6: both sides form the per-site terms in float32 and sum
them in float64, but the port's EM sums the members in another order and
its combo means add the sites in chunks (AF and mean GLs within a few
float32 spacings), which moves each per-site term by a few spacings and z,
over ~2,500 kept sites, by up to ~1e-5.

Also here: ``FilteringError`` is raised for the same individual, with the
same message, as the reference and the JAX package raise it.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import zscore_reference as zref
from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import population_map
from wgsassign_tpu_torch.io.synth import synth_cohort
from wgsassign_tpu_torch.models import zscore as tz
from wgsassign_tpu_torch.models.common import to_device
from wgsassign_tpu_torch.parallel.runtime import make_runtime

M, N, K = 3000, 24, 3


def _cohort(seed):
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=seed)
    rng = np.random.default_rng(seed + 100)
    g = np.concatenate([gl, 1.0 - gl.sum(axis=2, keepdims=True)], axis=2)
    jitter = rng.random((M, N)) < 0.2
    g = np.where(jitter[:, :, None],
                 g * np.exp(rng.normal(0.0, 0.1, g.shape)), g)
    g /= g.sum(axis=2, keepdims=True)
    gl = g[:, :, :2].astype(np.float32)
    return gl, labels, ad


def _port_inputs(gl, labels):
    names = [f"Ind{i}" for i in range(N)]
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(M)])
    return beagle, population_map(names, labels)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("single_read", [False, True])
@pytest.mark.parametrize("mode", ["reference", "assignment"])
def test_port_matches_plain_reference(mode, single_read, seed):
    gl, labels, ad = _cohort(seed)
    beagle, popmap = _port_inputs(gl, labels)
    cohort = to_device(beagle, make_runtime("cpu"))
    inds = range(N)
    if mode == "reference":
        got = tz.reference_z_scores(beagle, ad, popmap, cohort=cohort,
                                    single_read_threshold=single_read)
        want = zref.z_scores(gl, ad, inds, single_read=single_read,
                             labels=labels)
        np.testing.assert_array_equal(got.em_iters, want["iters"])
    else:
        pops = np.asarray([f"pop{j}" for j in range(K)])
        af = np.random.default_rng(seed).uniform(0.05, 0.95, (M, K)).astype(
            np.float32)
        assigned = labels[::-1]
        got = tz.assignment_z_scores(beagle, ad, assigned, af, pops,
                                     cohort=cohort,
                                     single_read_threshold=single_read)
        cols = [int(np.flatnonzero(pops == a)[0]) for a in assigned]
        want = zref.z_scores(gl, ad, inds, single_read=single_read, af=af,
                             af_cols=cols)
    assert (got.loci < M).all() and (got.loci > 0).all()
    np.testing.assert_array_equal(got.loci, want["loci"])
    np.testing.assert_allclose(got.z, want["z"], rtol=0, atol=1e-4)
    for name, ref in (("w_obs", "w_obs"), ("w_mu", "w_mu"),
                      ("w_var", "w_var")):
        np.testing.assert_allclose(getattr(got, name), want[ref], rtol=1e-6,
                                   err_msg=name)


def _failing_cohort():
    """Individual 5 has no reads (one combo); individual 9 has depths 0 and
    2 with the split (0, 2) never seen (no complete depth class);
    individual 13's depth-1 sites lie 0.1 from their combo means (no site
    kept); the others are sound."""
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=4)
    gl, ad = gl.copy(), ad.copy()
    ad[:, 10:12] = 0
    pattern = np.asarray([[0, 0], [2, 0], [1, 1]])[np.arange(M) % 3]
    ad[:, 18:20] = pattern
    ad[:, 26:28] = np.asarray([[0, 0], [1, 0], [0, 1]])[np.arange(M) % 3]
    wide = np.where((np.arange(M) // 3) % 2 == 0, 0.5, 0.7)
    gl[:, 13, 0] = np.where(np.arange(M) % 3 == 0, 1.0 / 3.0, wide)
    gl[:, 13, 1] = np.where(np.arange(M) % 3 == 0, 1.0 / 3.0,
                            (1.0 - wide) / 2.0)
    return gl, labels, ad


@pytest.mark.parametrize("start,message", [(0, 0), (6, 1), (10, 2),
                                           (14, None)])
def test_filtering_error_for_the_same_individual(start, message):
    from wgsassign_tpu.models import zscore as jz

    gl, labels, ad = _failing_cohort()
    beagle, popmap = _port_inputs(gl, labels)
    cohort = to_device(beagle, make_runtime("cpu"))
    inds = range(start, N)
    jax_msg = None
    for i in inds:
        try:
            jz.build_combo_tables(gl[:, i], ad[:, 2 * i: 2 * i + 2], 0, False)
        except jz.FilteringError as err:
            jax_msg = str(err)
            break
    if message is None:
        assert jax_msg is None
        got = tz.reference_z_scores(beagle, ad, popmap, start, N,
                                    cohort=cohort)
        want = zref.z_scores(gl, ad, inds, labels=labels)
        np.testing.assert_array_equal(got.loci, want["loci"])
        return
    with pytest.raises(tz.FilteringError) as port_err:
        tz.reference_z_scores(beagle, ad, popmap, start, N, cohort=cohort)
    with pytest.raises(zref.Filtered) as ref_err:
        zref.z_scores(gl, ad, inds, labels=labels)
    assert str(port_err.value) == str(ref_err.value) == jax_msg
    assert str(port_err.value) == zref.MESSAGES[message]
