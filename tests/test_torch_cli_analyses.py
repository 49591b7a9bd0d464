"""The port's CLI against the JAX package's CLI for the analyses beside the
main path, on one synthetic 600 x 30 x 3 cohort: ``--get_reference_af
--ne_obs --loo``, ``--get_pop_like``, the mixture (with no ``--beagle``),
and the port's ``--profile``, ``--debug_checks``, ``--devices 1`` and the
``--use_pallas``/``--no_pallas`` pair.

Tolerances: the Ne files rtol 1e-5, atol 1e-4 (as tests/test_torch_ne.py);
``.pop_like.txt`` rtol 1e-5, atol 2e-3 with identical argmax (as
tests/test_torch_assign.py); the mixture files byte for byte (the same
float64 numpy code and random stream on the same input file).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.cli import main as jax_main
from wgsassign_tpu.io.synth import synth_cohort, write_beagle
from wgsassign_tpu_torch.cli import main as torch_main

M, N, K = 600, 30, 3
NE_RTOL, NE_ATOL = 1e-5, 1e-4
LL_RTOL, LL_ATOL = 1e-5, 2e-3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("analyses")
    gl, labels, _ = synth_cohort(M, N, n_pops=K, seed=9)
    beagle = str(d / "cohort.beagle.gz")
    write_beagle(beagle, gl)
    ids = str(d / "ids.txt")
    with open(ids, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"Ind{i}\t{lab}\n")
    # harvest groups for the mixture that cut across the reference pops
    harvest = str(d / "harvest.txt")
    with open(harvest, "w") as f:
        for i in range(N):
            f.write(f"Ind{i}\tsite{i % 4}\n")
    return {"beagle": beagle, "ids": ids, "harvest": harvest, "dir": d}


def _both(files, name, argv):
    """Run both CLIs with ``argv``; returns their output prefixes."""
    out = {}
    for pkg in ("jax", "torch"):
        prefix = str(files["dir"] / f"{name}_{pkg}")
        if pkg == "torch":
            torch_main([*argv, "-o", prefix], device="cpu")
        else:
            jax_main([*argv, "-o", prefix])
        out[pkg] = prefix
    return out


@pytest.fixture(scope="module")
def ref_runs(files):
    return _both(files, "ref", ["--beagle", files["beagle"], "--pop_af_IDs",
                                files["ids"], "--get_reference_af",
                                "--ne_obs", "--loo"])


@pytest.mark.parametrize("suffix", [".fisher_obs.npy", ".ne_obs.npy"])
def test_ne_arrays_match_jax(ref_runs, suffix):
    want = np.load(ref_runs["jax"] + suffix)
    got = np.load(ref_runs["torch"] + suffix)
    assert got.dtype == np.float32 and got.shape == want.shape == (M, K)
    np.testing.assert_allclose(got, want, rtol=NE_RTOL, atol=NE_ATOL)


def test_ne_text_files_match_jax(ref_runs):
    want = np.loadtxt(ref_runs["jax"] + ".ne_obs.txt", dtype=str)
    got = np.loadtxt(ref_runs["torch"] + ".ne_obs.txt", dtype=str)
    assert got.shape == want.shape == (2, K)
    assert list(got[0]) == list(want[0])
    np.testing.assert_allclose(got[1].astype(float), want[1].astype(float),
                               rtol=NE_RTOL, atol=NE_ATOL)
    want = np.loadtxt(ref_runs["jax"] + ".ne_ind.txt")
    got = np.loadtxt(ref_runs["torch"] + ".ne_ind.txt")
    assert got.shape == want.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=NE_RTOL, atol=NE_ATOL)


def test_loo_beside_ne_matches_jax(ref_runs):
    import pandas as pd

    want = pd.read_csv(ref_runs["jax"] + ".pop_like_LOO.tsv", sep="\t")
    got = pd.read_csv(ref_runs["torch"] + ".pop_like_LOO.tsv", sep="\t")
    assert got.iloc[:, :2].equals(want.iloc[:, :2])
    np.testing.assert_allclose(got.iloc[:, 2:].to_numpy(),
                               want.iloc[:, 2:].to_numpy(),
                               rtol=LL_RTOL, atol=LL_ATOL)


@pytest.fixture(scope="module")
def pop_like_runs(files, ref_runs):
    # both read the JAX run's AF file
    return _both(files, "pl", ["--beagle", files["beagle"], "--pop_af_file",
                               ref_runs["jax"] + ".pop_af.npy",
                               "--get_pop_like"])


def test_pop_like_matches_jax(pop_like_runs):
    want = np.loadtxt(pop_like_runs["jax"] + ".pop_like.txt")
    got = np.loadtxt(pop_like_runs["torch"] + ".pop_like.txt")
    assert got.shape == want.shape == (N, K)
    np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=LL_ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("stable", [False, True])
def test_mixture_files_equal_jax(files, pop_like_runs, stable):
    """Mixture with no --beagle, on the JAX run's .pop_like.txt."""
    flags = ["--pop_like", pop_like_runs["jax"] + ".pop_like.txt",
             "--pop_like_IDs", files["harvest"], "--get_em_mix",
             "--get_mcmc_mix", "--mcmc_seed", "3"]
    runs = _both(files, f"mix_{stable}",
                 flags + (["--stable_mix"] if stable else []))
    for suffix in (".em_mix.txt", ".mcmc_mix.txt"):
        with open(runs["jax"] + suffix, "rb") as f:
            want = f.read()
        with open(runs["torch"] + suffix, "rb") as f:
            got = f.read()
        assert got == want, suffix
        rows = np.loadtxt(runs["torch"] + suffix, dtype=str)
        assert rows.shape == (4, 1 + K)


def test_mcmc_last_draw_equals_jax(files, pop_like_runs):
    runs = _both(files, "mix_last", [
        "--pop_like", pop_like_runs["jax"] + ".pop_like.txt",
        "--pop_like_IDs", files["harvest"], "--get_mcmc_mix",
        "--mcmc_seed", "5", "--mcmc_last_draw", "--mixture_iter", "40"])
    with open(runs["jax"] + ".mcmc_mix.txt") as f:
        want = f.read()
    with open(runs["torch"] + ".mcmc_mix.txt") as f:
        assert f.read() == want


def test_profile_writes_a_loadable_trace(files, tmp_path):
    trace_dir = tmp_path / "trace"
    torch_main(["--beagle", files["beagle"], "--pop_af_IDs", files["ids"],
                "--get_reference_af", "--profile", str(trace_dir),
                "-o", str(tmp_path / "p")], device="cpu")
    paths = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        trace = json.load(f)
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
    assert os.path.exists(str(tmp_path / "p") + ".pop_af.npy")


def test_debug_checks_raise_on_a_malformed_triple(files, tmp_path):
    """--debug_checks runs the sanitiser before the likelihood passes: a GL
    triple with g0 + g1 > 1 where the AF is high has a negative likelihood
    and raises, in the --get_pop_like pass and in the LOO pass."""
    from wgsassign_tpu.io.beagle import read_beagle
    from wgsassign_tpu.io.ids import read_ids
    from wgsassign_tpu_torch.models.loo import leave_one_out
    from wgsassign_tpu_torch.parallel.runtime import make_runtime

    gl, _, _ = synth_cohort(M, N, n_pops=K, seed=9)
    gl[5, 2] = (0.5, 0.9)  # g2 = -0.4
    bad = str(tmp_path / "bad.beagle.gz")
    write_beagle(bad, gl)
    af = np.full((M, K), 0.5, np.float32)
    af[5] = 0.95  # likelihood 0.5(1-a)^2 + 1.8a(1-a) - 0.4a^2 < 0
    af_path = str(tmp_path / "af.npy")
    np.save(af_path, af)
    argv = ["--beagle", bad, "--pop_af_file", af_path, "--get_pop_like",
            "-o", str(tmp_path / "b")]
    with pytest.raises(ValueError, match=r"at 3 \(site, individual"):
        torch_main([*argv, "--debug_checks"], device="cpu")
    torch_main(argv, device="cpu")  # unchecked, the run goes through
    assert not np.isfinite(np.loadtxt(str(tmp_path / "b") + ".pop_like.txt")
                           [2]).any()
    beagle, popmap = read_beagle(bad), read_ids(files["ids"])
    with pytest.raises(ValueError, match="non-positive assignment"):
        leave_one_out(beagle, af, popmap,
                      runtime=make_runtime("cpu", debug_checks=True))


def test_every_flag_is_ported():
    """The port's parser is the JAX CLI's, flag for flag, and the module
    keeps no list of flags that raise."""
    import wgsassign_tpu.cli as jax_cli
    import wgsassign_tpu_torch.cli as torch_cli

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions}

    assert flags(torch_cli.parser) == flags(jax_cli.parser)
    assert not hasattr(torch_cli, "_NOT_PORTED")
    assert not hasattr(torch_cli, "_check_ported")


def test_devices_one_is_one_rank(files, ref_runs, pop_like_runs, tmp_path,
                                 capsys):
    prefix = str(tmp_path / "d")
    torch_main(["--beagle", files["beagle"], "--get_pop_like",
                "--pop_af_file", ref_runs["jax"] + ".pop_af.npy",
                "--devices", "1", "-o",
                prefix], device="cpu")
    assert "Mesh: 1 rank(s)" in capsys.readouterr().out
    assert (open(prefix + ".pop_like.txt").read()
            == open(pop_like_runs["torch"] + ".pop_like.txt").read())
    assert "-devices 1" in open(prefix + ".args").read()


def test_pallas_flags_are_exclusive(files, tmp_path):
    """Both together raise with the JAX CLI's message."""
    argv = ["--beagle", files["beagle"], "--get_pop_like", "--use_pallas",
            "--no_pallas", "-o", str(tmp_path / "p")]
    errors = []
    for run, kwargs in ((jax_main, {}), (torch_main, {"device": "cpu"})):
        with pytest.raises(ValueError) as info:
            run(argv, **kwargs)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "mutually exclusive" in errors[1]
