"""The port's z-score CLI against the JAX package's CLI on the CPU, on the
same synthetic Beagle, allele-depth, ID and population-names files, with
no ``--get_reference_af`` in the z-score commands.

Tolerance: ``.reference_z_ind.txt`` and ``.z_ind.txt`` to atol 1e-4 (float32
sums over ~500 kept sites per individual in another order; the files hold
seven decimals).  Also here: the allele-depth writer of ``chip_smoke.py``,
which must reproduce ``synth_cohort``'s depths row for row beside a
``synth_beagle_file``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.cli import main as jax_main
from wgsassign_tpu.io.ad import read_allele_depths
from wgsassign_tpu.io.beagle import read_beagle
from wgsassign_tpu.io.synth import synth_beagle_file, synth_cohort, write_beagle
from wgsassign_tpu_torch.cli import main as torch_main

M, N, K = 512, 16, 2

CONFIGS = {
    "both": [],
    "threshold": ["--allele_count_threshold", "2"],
    "ind_range": ["--ind_start", "3", "--ind_end", "11"],
    "single_read": ["--single_read_threshold"],
}


@pytest.fixture(scope="module")
def cohort_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("zcohort")
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=2)
    beagle = str(d / "cohort.beagle.gz")
    write_beagle(beagle, gl)
    ad_path = str(d / "cohort.ad.txt")
    np.savetxt(ad_path, ad, fmt="%d")
    ids = str(d / "ids.txt")
    with open(ids, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"Ind{i}\t{lab}\n")
    ref = str(d / "ref")
    jax_main(["--beagle", beagle, "--pop_af_IDs", ids, "--get_reference_af",
              "-o", ref])
    return {"beagle": beagle, "ad": ad_path, "ids": ids, "dir": d,
            "pop_af": ref + ".pop_af.npy", "pop_names": ref + ".pop_names.txt"}


def _argv(files, prefix, extra):
    return ["--beagle", files["beagle"], "--pop_af_IDs", files["ids"],
            "--ind_ad_file", files["ad"], "--pop_names", files["pop_names"],
            "--pop_af_file", files["pop_af"], "--get_reference_z_score",
            "--get_assignment_z_score", "-o", prefix, *extra]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, cohort_files):
    name = request.param
    out = {}
    for pkg in ("jax", "torch"):
        prefix = str(cohort_files["dir"] / f"{name}_{pkg}")
        argv = _argv(cohort_files, prefix, CONFIGS[name])
        if pkg == "torch":
            torch_main(argv, device="cpu")
        else:
            jax_main(argv)
        out[pkg] = prefix
    out["name"] = name
    return out


@pytest.mark.parametrize("suffix", [".reference_z_ind.txt", ".z_ind.txt"])
def test_z_files_match_jax(runs, suffix):
    want = np.loadtxt(runs["jax"] + suffix, ndmin=1)
    got = np.loadtxt(runs["torch"] + suffix, ndmin=1)
    flags = CONFIGS[runs["name"]]
    n_expected = 8 if "--ind_start" in flags else N
    assert got.shape == want.shape == (n_expected,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_filtering_error_surfaces_alike(cohort_files, tmp_path):
    """Too stringent a threshold: both CLIs raise a FilteringError (a
    ValueError) with the reference's message."""
    errors = []
    for pkg, run in (("jax", jax_main), ("torch", torch_main)):
        argv = _argv(cohort_files, str(tmp_path / pkg),
                     ["--allele_count_threshold", "1000000"])
        kwargs = {"device": "cpu"} if pkg == "torch" else {}
        with pytest.raises(ValueError) as info:
            run(argv, **kwargs)
        errors.append(info.value)
    assert [type(e).__name__ for e in errors] == ["FilteringError"] * 2
    assert str(errors[0]) == str(errors[1])
    assert "Not enough allele-count combinations" in str(errors[1])


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ad_writer_matches_synth(tmp_path):
    """Row r of the AD file belongs to site r of the Beagle file, across
    the generator's site chunks."""
    m, n, k, seed, chunk = 250, 6, 2, 4, 100
    beagle = str(tmp_path / "s.beagle.gz")
    ad_path = str(tmp_path / "s.ad.txt")
    synth_beagle_file(beagle, m, n, n_pops=k, seed=seed, chunk=chunk)
    _chip_smoke().write_synth_ad(ad_path, m, n, k, seed, chunk=chunk)
    gls, ads = [], []
    for lo in range(0, m, chunk):
        gl, _, ad = synth_cohort(min(lo + chunk, m) - lo, n, n_pops=k,
                                 seed=seed + 1 + lo)
        gls.append(gl)
        ads.append(ad)
    got = read_allele_depths(ad_path, n_sites=m, n_inds=n)
    np.testing.assert_array_equal(got, np.concatenate(ads))
    np.testing.assert_allclose(read_beagle(beagle).gl, np.concatenate(gls),
                               rtol=0, atol=1e-6)
