"""The port's main path, ``--get_reference_af --loo``, end to end on the CPU
against the JAX package's CLI on the same synthetic Beagle file.

Tolerances: ``.pop_af.npy`` atol 1e-5 (EM member sums in another order);
LOO log-likelihoods rtol 1e-5, atol 2e-3, as tests/test_cli.py holds the JAX
CLI to the reference's goldens.  Convergence iteration counts are compared
at the model level and must be equal.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.cli import main as jax_main
from wgsassign_tpu.io.beagle import read_beagle
from wgsassign_tpu.io.ids import read_ids
from wgsassign_tpu.io.synth import synth_cohort, write_beagle
from wgsassign_tpu_torch.cli import main as torch_main

M, N, K = 600, 30, 3

CONFIGS = {
    "plain": [],
    "partitions_clean": ["--partition_sites", "4", "--loo_clean_af"],
    "downsampled": ["--loo_downsampled_beagle", "{ds}", "--partition_sites",
                    "3", "--no_fast_em"],
}


@pytest.fixture(scope="module")
def cohort_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cohort")
    gl, labels, _ = synth_cohort(M, N, n_pops=K, seed=0)
    beagle = str(d / "cohort.beagle.gz")
    write_beagle(beagle, gl)
    ids = str(d / "ids.txt")
    with open(ids, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"Ind{i}\t{lab}\n")
    # a downsampled file over 80% of the sites, with other GLs
    gl_ds, _, _ = synth_cohort(M, N, n_pops=K, seed=1)
    full_ds = str(d / "full_ds.beagle.gz")
    write_beagle(full_ds, gl_ds)
    ds = str(d / "ds.beagle.gz")
    with gzip.open(full_ds, "rt") as src, gzip.open(ds, "wt") as dst:
        for i, line in enumerate(src):
            if i == 0 or i % 5:
                dst.write(line)
    return {"beagle": beagle, "ids": ids, "ds": ds, "dir": d}


def _flags(files, name):
    return [f.format(ds=files["ds"]) for f in CONFIGS[name]]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, cohort_files):
    """Both CLIs on one configuration; returns their output prefixes."""
    name = request.param
    out = {}
    for pkg, run in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(cohort_files["dir"] / f"{name}_{pkg}")
        argv = ["--beagle", cohort_files["beagle"],
                "--pop_af_IDs", cohort_files["ids"],
                "--get_reference_af", "--loo", "-o", prefix,
                *_flags(cohort_files, name)]
        if pkg == "torch":
            run(argv, device="cpu")
        else:
            run(argv)
        out[pkg] = prefix
    out["name"] = name
    return out


def _loo_tsv(prefix, name):
    suffix = "_downsampled" if name == "downsampled" else ""
    return f"{prefix}.pop_like_LOO{suffix}.tsv"


def test_pop_af_matches_jax(runs):
    ref = np.load(runs["jax"] + ".pop_af.npy")
    got = np.load(runs["torch"] + ".pop_af.npy")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_pop_names_match_jax(runs):
    ref = open(runs["jax"] + ".pop_names.txt").read()
    assert open(runs["torch"] + ".pop_names.txt").read() == ref


def test_loo_tsv_matches_jax(runs):
    ref = pd.read_csv(_loo_tsv(runs["jax"], runs["name"]), sep="\t")
    got = pd.read_csv(_loo_tsv(runs["torch"], runs["name"]), sep="\t")
    assert list(got.columns) == list(ref.columns)
    assert got.iloc[:, :2].equals(ref.iloc[:, :2])
    np.testing.assert_allclose(got.iloc[:, 2:].to_numpy(),
                               ref.iloc[:, 2:].to_numpy(),
                               rtol=1e-5, atol=2e-3)


def test_partition_tsv_matches_jax(runs):
    flags = CONFIGS[runs["name"]]
    if "--partition_sites" not in flags:
        assert not any(p.endswith(".tsv.gz")
                       for p in os.listdir(os.path.dirname(runs["torch"]))
                       if p.startswith(runs["name"] + "_torch"))
        return
    p = flags[flags.index("--partition_sites") + 1]
    suffix = "_downsampled" if runs["name"] == "downsampled" else ""
    path = ".pop_like_LOO{}_partitions_{}.tsv.gz".format(suffix, p)
    with gzip.open(runs["jax"] + path, "rt") as f:
        ref = pd.read_csv(f, sep="\t")
    with gzip.open(runs["torch"] + path, "rt") as f:
        got = pd.read_csv(f, sep="\t")
    assert list(got.columns) == list(ref.columns)
    assert len(got) == N * int(p)
    np.testing.assert_allclose(got.iloc[:, 3:].to_numpy(),
                               ref.iloc[:, 3:].to_numpy(),
                               rtol=1e-5, atol=2e-3)


def test_model_iterations_match_jax(cohort_files):
    """Reference-AF and every LOO problem converge at the same iteration
    as in the JAX package."""
    from wgsassign_tpu.models.loo import leave_one_out as jax_loo
    from wgsassign_tpu.models.reference_af import (
        estimate_reference_af as jax_ref_af,
    )
    from wgsassign_tpu_torch.models.common import to_device
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = read_beagle(cohort_files["beagle"])
    popmap = read_ids(cohort_files["ids"])
    ref = jax_ref_af(beagle, popmap)
    cohort = to_device(beagle, make_runtime("cpu"))
    res = estimate_reference_af(beagle, popmap, cohort=cohort)
    np.testing.assert_array_equal(res.iters, ref.iters)
    assert res.converged.all()
    loo_ref = jax_loo(beagle, ref.af, popmap)
    loo = leave_one_out(beagle, res.af, popmap, cohort=cohort,
                        af_t_dev=res.af_t_dev)
    np.testing.assert_array_equal(loo.iters, loo_ref.iters)
    np.testing.assert_array_equal(loo.converged, loo_ref.converged)
    np.testing.assert_allclose(loo.ll, loo_ref.ll, rtol=1e-5, atol=2e-3)


def test_loo_restart_files_resume(cohort_files, tmp_path):
    """A population's ``.pop{j}.done.npz`` (here written by the JAX
    package) is picked up by the port, and the files are removed at the
    end."""
    from wgsassign_tpu.models.loo import _save_pop_done as jax_save_done
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    beagle = read_beagle(cohort_files["beagle"])
    popmap = read_ids(cohort_files["ids"])
    rt = make_runtime("cpu")
    res = estimate_reference_af(beagle, popmap, runtime=rt)
    full = leave_one_out(beagle, res.af, popmap, runtime=rt)
    members = popmap.members_of(popmap.pops[1])
    ckpt = str(tmp_path / "run.loo.ckpt")
    # population 1 "finished" in an earlier run, with marker iterations
    f_done = np.full((len(members), M), 0.3, np.float32)
    jax_save_done(f"{ckpt}.pop1.done.npz", f_done,
                  np.full(len(members), 7, np.int32),
                  np.ones(len(members), bool), M)
    resumed = leave_one_out(beagle, res.af, popmap, runtime=rt,
                            checkpoint_path=ckpt)
    assert np.all(resumed.iters[members] == 7)
    others = np.setdiff1d(np.arange(N), members)
    np.testing.assert_array_equal(resumed.iters[others], full.iters[others])
    assert not any(p.startswith("run.loo.ckpt") for p in os.listdir(tmp_path))


def test_torch_cli_never_loads_jax(cohort_files, tmp_path):
    """A subprocess, because this pytest process has imported jax.  The
    port's modules are imported and the analyses run; at the end neither
    ``jax`` nor any module of ``wgsassign_tpu`` is loaded."""
    sub = str(tmp_path / "sub")
    modules = ", ".join(
        f"wgsassign_tpu_torch.{m}" for m in (
            "models.assign", "models.common", "models.loo", "models.mixture",
            "models.ne", "models.reference_af", "models.zscore",
            "ops.fisher", "ops.loglik", "obs.profiling", "parallel.runtime"))
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        f"import {modules}\n"
        "from wgsassign_tpu_torch.cli import main\n"
        f"main(['--beagle', {cohort_files['beagle']!r}, '--pop_af_IDs', "
        f"{cohort_files['ids']!r}, '--get_reference_af', '--ne_obs', "
        f"'--loo', '--stream_ingest', '0', '--debug_checks', '--profile', "
        f"{str(tmp_path / 'trace')!r}, '-o', {sub!r}], device='cpu')\n"
        f"main(['--beagle', {cohort_files['beagle']!r}, '--get_pop_like', "
        f"'--pop_af_file', {sub + '.pop_af.npy'!r}, '-o', {sub!r}], "
        "device='cpu')\n"
        f"main(['--pop_like', {sub + '.pop_like.txt'!r}, '--pop_like_IDs', "
        f"{cohort_files['ids']!r}, '--get_em_mix', '--get_mcmc_mix', "
        f"'-o', {sub!r}], device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'wgsassign_tpu'))\n"
        "assert not bad, f'loaded: {bad}'\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_JAX_OK" in proc.stdout
    for suffix in (".pop_like_LOO.tsv", ".ne_ind.txt", ".pop_like.txt",
                   ".em_mix.txt", ".mcmc_mix.txt"):
        assert os.path.exists(sub + suffix), suffix


@pytest.fixture(scope="module")
def flag_inputs(cohort_files):
    """What the engine-flag cases below need beside the cohort: an
    allele-depth file, and a default one-rank run of every analysis the
    cases add to ``--get_reference_af`` (their outputs are the baseline)."""
    d = cohort_files["dir"]
    _, _, ad = synth_cohort(M, N, n_pops=K, seed=0)
    ad_path = str(d / "cohort.ad.txt")
    np.savetxt(ad_path, ad, fmt="%d")
    base = str(d / "flags_base")
    common = ["--beagle", cohort_files["beagle"], "--pop_af_IDs",
              cohort_files["ids"]]
    torch_main([*common, "--get_reference_af", "--ne_obs", "-o", base],
               device="cpu")
    inputs = {
        "common": common, "base": base,
        "pop_like": ["--pop_af_file", base + ".pop_af.npy"],
        "z": ["--ind_ad_file", ad_path, "--pop_names",
              base + ".pop_names.txt", "--pop_af_file", base + ".pop_af.npy"],
        "mix": ["--pop_like", base + ".pop_like.txt", "--pop_like_IDs",
                cohort_files["ids"], "--mcmc_seed", "3"],
    }
    torch_main([*common, *inputs["z"], "--get_pop_like",
                "--get_reference_z_score", "--get_assignment_z_score",
                "-o", base], device="cpu")
    torch_main([*inputs["mix"], "--get_em_mix", "--get_mcmc_mix", "-o", base],
               device="cpu")
    return inputs


@pytest.mark.parametrize("flags, needs, outputs", [
    # the engine flags beside each analysis: --devices 1 is one rank,
    # --use_pallas the default engine (files byte for byte); --no_pallas the
    # plain EM ops (AF atol 1e-5, z atol 1e-4)
    (["--devices", "1", "--get_pop_like"], "pop_like", [".pop_like.txt"]),
    (["--devices", "1", "--ne_obs"], None,
     [".ne_obs.npy", ".fisher_obs.npy", ".ne_ind.txt"]),
    (["--devices", "1", "--stream_ingest", "0", "--get_assignment_z_score"],
     "z", [".z_ind.txt"]),
    (["--devices", "1", "--get_reference_z_score"], "z",
     [".reference_z_ind.txt"]),
    (["--use_pallas", "--get_em_mix"], "mix", [".em_mix.txt"]),
    (["--no_pallas", "--get_mcmc_mix"], "mix", [".mcmc_mix.txt"]),
    (["--devices", "1", "--stream_ingest", "0"], None, []),
    (["--devices", "1"], None, []),
    (["--use_pallas"], None, []),
    (["--no_pallas"], None, []),
    (["--use_pallas", "--debug_checks"], None, []),
    (["--no_pallas", "--profile", "trace"], None, []),
    (["--no_pallas", "--get_reference_z_score"], "z",
     [".reference_z_ind.txt"]),
])
def test_engine_flags_run(flags, needs, outputs, flag_inputs, tmp_path,
                          capsys):
    """No flag raises ``NotImplementedError``: each combination runs with
    ``--get_reference_af`` and writes the default run's files."""
    prefix = str(tmp_path / "x")
    flags = [str(tmp_path / "trace") if f == "trace" else f for f in flags]
    torch_main([*flag_inputs["common"], *(flag_inputs[needs] if needs else []),
                "--get_reference_af", "-o", prefix, *flags], device="cpu")
    printed = capsys.readouterr().out
    plain = "--no_pallas" in flags
    assert f"EM (MAF) engine: {'plain' if plain else 'em_chunk'}" in printed
    base = flag_inputs["base"]
    got, want = np.load(prefix + ".pop_af.npy"), np.load(base + ".pop_af.npy")
    if plain:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    for suffix in outputs:
        if suffix.endswith(".npy"):
            np.testing.assert_array_equal(np.load(prefix + suffix),
                                          np.load(base + suffix))
        elif plain and suffix.endswith("z_ind.txt"):
            np.testing.assert_allclose(np.loadtxt(prefix + suffix),
                                       np.loadtxt(base + suffix),
                                       rtol=0, atol=1e-4)
        else:
            assert (open(prefix + suffix).read()
                    == open(base + suffix).read()), suffix
    if "--profile" in flags:
        assert os.listdir(tmp_path / "trace")


def test_default_device_needs_cuda(cohort_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["--beagle", cohort_files["beagle"], "-o",
                    str(tmp_path / "x")])
