"""Several ranks of the port on the CPU: two gloo ranks, each with a window
of the site axis, against the one-rank port and against the JAX package on
one device, on one synthetic 600 x 30 x 3 cohort (``synth_cohort``, seed 0).

Every command runs once: the one-rank port and the JAX package in this
process, the two ranks in two worker processes
(``tests/test_torch_rank_worker.py``) that take the commands in turn, and
``--devices 2`` through ``main(..., device="cpu")``.  The cases below read
the files and logs those runs left.

Tolerances, two ranks against one rank and against the JAX package alike:
AF atol 1e-5; log-likelihoods rtol 1e-5, atol 2e-3 with identical argmax; Ne
rtol 1e-5, atol 1e-4; z atol 1e-4 with equal loci.  EM iterations must be
equal for every population and every problem: on this cohort no RMSE lies
within rounding of the tolerance, so the one allowed difference (the sum over
ranks rounds differently from one rank's sum) is not used.
"""

import contextlib
import glob
import gzip
import importlib.util
import io
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.cli import main as jax_main
from wgsassign_tpu.io.synth import synth_cohort, write_beagle
from wgsassign_tpu_torch.cli import main as torch_main

M, N, K = 600, 30, 3
WORLD = 2
WAIT_S = 240  # of the worker processes, all commands together
HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "test_torch_rank_worker.py")


def _worker_module():
    spec = importlib.util.spec_from_file_location("rank_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hold_ports(n):
    """``(base, sockets)``: ``n`` consecutive local ports from ``base``, each
    bound by a socket of this process (``SO_REUSEADDR``, not listening)
    until the caller closes them.  A held port is refused to every other
    plain ``bind`` (another test's listening socket among them), yet rank
    0's store (which sets ``SO_REUSEADDR`` too) binds and listens on it:
    the ports stay free for the ranks for as long as they run, however
    many other processes open ports meanwhile."""
    while True:
        held = []
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                base = s.getsockname()[1]
            if base + n >= 65535:
                continue
            for p in range(base, base + n):
                s = socket.socket()
                held.append(s)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", p))
            return base, held
        except OSError:
            for s in held:
                s.close()


def _wait_ranks(procs, err_paths, wait_s):
    """Wait for every rank, but no longer than ``wait_s`` seconds in all and
    no longer than until one fails.  Returns each rank's exit code (None
    for a rank still running, which the caller stops) and the end of each
    rank's standard error, for the failure message."""
    deadline = time.monotonic() + wait_s
    while any(p.poll() is None for p in procs):
        if (any(p.returncode not in (None, 0) for p in procs)
                or time.monotonic() > deadline):
            break
        time.sleep(0.1)
    codes = [p.poll() for p in procs]
    report = "".join(
        f"\n-- rank {r}, exit {c}, its stderr's end:\n"
        f"{err.read_text()[-3000:]}"
        for r, (c, err) in enumerate(zip(codes, err_paths)))
    return codes, report


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=0)
    f = {"dir": d, "beagle": str(d / "c.beagle.gz"), "ids": str(d / "ids.txt"),
         "ad": str(d / "c.ad.txt"), "ds": str(d / "ds.beagle.gz"),
         "tiny": str(d / "tiny.beagle.gz")}
    write_beagle(f["beagle"], gl)
    np.savetxt(f["ad"], ad, fmt="%d")
    with open(f["ids"], "w") as fh:
        for i, lab in enumerate(labels):
            fh.write(f"Ind{i}\t{lab}\n")
    # a downsampled file over 80% of the sites, with other GLs
    gl_ds, _, _ = synth_cohort(M, N, n_pops=K, seed=1)
    full_ds = str(d / "full_ds.beagle.gz")
    write_beagle(full_ds, gl_ds)
    with gzip.open(full_ds, "rt") as src, gzip.open(f["ds"], "wt") as dst:
        for i, line in enumerate(src):
            if i == 0 or i % 5:
                dst.write(line)
    # 3 sites: fewer than ranks x --partition_sites 4, so rank 1's window
    # lies wholly in the padded tail
    write_beagle(f["tiny"], gl[:3])
    return f


def _commands(f, tag, af_prefix):
    """name -> argv (without ``-o``) of every CLI command under test."""
    base = ["--beagle", f["beagle"], "--pop_af_IDs", f["ids"]]
    z = ["--ind_ad_file", f["ad"], "--pop_names", af_prefix + ".pop_names.txt",
         "--pop_af_file", af_prefix + ".pop_af.npy"]
    ref = [*base, "--get_reference_af"]
    return {
        "head": [*ref, "--ne_obs", "--loo"],
        "part": [*ref, "--loo", "--partition_sites", "3"],
        "ds": [*ref, "--loo", "--loo_downsampled_beagle", f["ds"],
               "--partition_sites", "3"],
        "stream": [*ref, "--ne_obs", "--loo", "--stream_ingest", "100"],
        "stream_ds": [*ref, "--loo", "--stream_ingest", "0",
                      "--loo_downsampled_beagle", f["ds"]],
        "tiny": ["--beagle", f["tiny"], "--pop_af_IDs", f["ids"],
                 "--get_reference_af", "--loo", "--stream_ingest", "0",
                 "--partition_sites", "4"],
        "tiny_mem": ["--beagle", f["tiny"], "--pop_af_IDs", f["ids"],
                     "--get_reference_af", "--loo", "--partition_sites", "4"],
        "pop_like": [*base, "--get_pop_like", "--pop_af_file",
                     af_prefix + ".pop_af.npy"],
        "z": [*base, *z, "--get_reference_z_score",
              "--get_assignment_z_score"],
        "z_stream": [*base, *z, "--get_reference_z_score",
                     "--get_assignment_z_score", "--stream_ingest", "0"],
        "z_single": [*base, *z, "--get_reference_z_score",
                     "--single_read_threshold"],
        "no_pallas": [*ref, "--loo", "--no_pallas"],
        "resume": [*ref, "--loo", "--em_checkpoint"],
    }


JAX_COMMANDS = ("head", "ds", "pop_like", "z")


@pytest.fixture(scope="module")
def runs(files):
    """Runs everything once.  Returns ``prefix(kind, name)`` for kind in
    ``one`` (one-rank port), ``two`` (two gloo ranks), ``jax`` and
    ``devices`` (``--devices 2``), the captured logs, and the model-level
    npz files."""
    d = files["dir"]
    worker = _worker_module()

    def prefix(kind, name):
        return str(d / f"{kind}_{name}")

    # the AF files every pop_like / z command reads: the one-rank head run
    af_prefix = prefix("one", "head")
    cmds = _commands(files, "", af_prefix)
    logs = {}

    def run_one(name):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            torch_main([*cmds[name], "-o", prefix("one", name)], device="cpu")
        logs["one", name] = buf.getvalue()

    run_one("head")
    # restart files: written by two ranks for the one-rank resume, and by
    # one rank for the two-rank resume
    worker.write_checkpoints(files["beagle"], files["ids"],
                             prefix("two", "resume"))
    two_cmds = [[*argv, "-o", prefix("two", name)]
                for name, argv in cmds.items()]
    two_cmds.insert(0, ["@ckpt", files["beagle"], files["ids"],
                        prefix("one", "resume")])
    two_cmds.append(["@model", files["beagle"], files["ids"], files["ad"],
                     prefix("two", "model") + ".npz"])
    cmd_file = str(d / "two_cmds.json")
    with open(cmd_file, "w") as fh:
        json.dump(two_cmds, fh)
    port, held = _hold_ports(len(two_cmds))
    env = dict(os.environ)
    for var in ("WGSA_COORDINATOR_ADDRESS", "WGSA_NUM_PROCESSES",
                "WGSA_PROCESS_ID"):
        env.pop(var, None)
    # the workers write to files: nothing reads a pipe while this process
    # is busy with its own runs
    sinks = [(open(d / f"rank{rank}.out", "w"), open(d / f"rank{rank}.err", "w"))
             for rank in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(rank), str(WORLD), str(port), cmd_file],
        stdout=sinks[rank][0], stderr=sinks[rank][1], env=env)
        for rank in range(WORLD)]
    try:
        # meanwhile, in this process: the other one-rank runs, --devices 2
        # and the JAX package on one device
        for name in cmds:
            if name not in ("head", "resume"):
                run_one(name)
        worker.run_model(files["beagle"], files["ids"], files["ad"],
                         prefix("one", "model") + ".npz")
        with contextlib.redirect_stdout(io.StringIO()):
            torch_main([*cmds["head"], "--devices", "2", "-o",
                        prefix("devices", "head")], device="cpu")
        for name in JAX_COMMANDS:
            with contextlib.redirect_stdout(io.StringIO()):
                jax_main([*cmds[name], "--devices", "1", "-o",
                          prefix("jax", name)])
        codes, report = _wait_ranks(
            procs, [d / f"rank{rank}.err" for rank in range(WORLD)], WAIT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out, err in sinks:
            out.close()
            err.close()
        for sock in held:
            sock.close()
    assert codes == [0] * WORLD, f"the ranks failed: {codes}{report}"
    outs = []
    for rank in range(WORLD):
        out = (d / f"rank{rank}.out").read_text()
        assert "ALL_COMMANDS_DONE" in out, report
        outs.append(out)
    # rank 0's log, cut into the commands' sections
    sections = outs[0].split("== command ")[1:]
    for (name, _), text in zip(
            [("ckpt", None), *cmds.items(), ("model", None)], sections):
        logs["two", name] = text
    logs["two_rank1"] = outs[1]
    # the one-rank resume, from the files the two ranks wrote
    run_one("resume")
    return {"prefix": prefix, "logs": logs, "cmds": cmds}


def _assert_ll_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


def _tsv_numbers(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        df = pd.read_csv(fh, sep="\t")
    return df, df.select_dtypes("number").drop(
        columns=["data_part"], errors="ignore").to_numpy()


def _iteration_lines(log):
    return [ln for ln in log.splitlines()
            if re.search(r"converged at iteration|iterations \d+\.\.\d+", ln)]


OTHER = ["one", "jax"]


@pytest.mark.parametrize("other", OTHER)
@pytest.mark.parametrize("name", ["head", "ds"])
def test_pop_af(runs, name, other):
    got = np.load(runs["prefix"]("two", name) + ".pop_af.npy")
    want = np.load(runs["prefix"](other, name) + ".pop_af.npy")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("other", OTHER)
@pytest.mark.parametrize("suffix", [".fisher_obs.npy", ".ne_obs.npy"])
def test_ne_arrays(runs, suffix, other):
    got = np.load(runs["prefix"]("two", "head") + suffix)
    want = np.load(runs["prefix"](other, "head") + suffix)
    assert got.shape == want.shape == (M, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("other", OTHER)
def test_ne_ind(runs, other):
    got = np.loadtxt(runs["prefix"]("two", "head") + ".ne_ind.txt")
    want = np.loadtxt(runs["prefix"](other, "head") + ".ne_ind.txt")
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("other", OTHER)
@pytest.mark.parametrize("name, suffix", [
    ("head", ".pop_like_LOO.tsv"),
    ("ds", ".pop_like_LOO_downsampled.tsv"),
    ("ds", ".pop_like_LOO_downsampled_partitions_3.tsv.gz"),
])
def test_loo_files(runs, name, suffix, other):
    got_df, got = _tsv_numbers(runs["prefix"]("two", name) + suffix)
    want_df, want = _tsv_numbers(runs["prefix"](other, name) + suffix)
    assert list(got_df.columns) == list(want_df.columns)
    assert got_df.iloc[:, :2].equals(want_df.iloc[:, :2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    if "partitions" not in suffix:
        _assert_ll_close(got, want)


@pytest.mark.parametrize("other", OTHER)
def test_pop_like(runs, other):
    got = np.loadtxt(runs["prefix"]("two", "pop_like") + ".pop_like.txt")
    want = np.loadtxt(runs["prefix"](other, "pop_like") + ".pop_like.txt")
    assert got.shape == (N, K)
    _assert_ll_close(got, want)


@pytest.mark.parametrize("other", OTHER)
@pytest.mark.parametrize("suffix", [".reference_z_ind.txt", ".z_ind.txt"])
def test_z_files(runs, suffix, other):
    got = np.loadtxt(runs["prefix"]("two", "z") + suffix)
    want = np.loadtxt(runs["prefix"](other, "z") + suffix)
    assert got.shape == (N,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["part", "stream", "stream_ds", "tiny",
                                  "tiny_mem", "z_stream", "no_pallas"])
def test_files_equal_one_rank(runs, name):
    """Every file of the one-rank run exists from the two ranks too, and no
    other: arrays to the module's tolerances, iteration lines equal."""
    one, two = runs["prefix"]("one", name), runs["prefix"]("two", name)
    suffixes = sorted(p[len(one):] for p in glob.glob(one + ".*"))
    assert suffixes == sorted(p[len(two):] for p in glob.glob(two + ".*"))
    assert len(suffixes) >= 3
    for suffix in suffixes:
        if suffix.endswith(".npy"):
            atol = 1e-5 if suffix == ".pop_af.npy" else 1e-4
            np.testing.assert_allclose(np.load(two + suffix),
                                       np.load(one + suffix),
                                       rtol=1e-5, atol=atol)
        elif ".tsv" in suffix:
            _, got = _tsv_numbers(two + suffix)
            _, want = _tsv_numbers(one + suffix)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
        elif suffix.endswith("z_ind.txt"):
            np.testing.assert_allclose(np.loadtxt(two + suffix),
                                       np.loadtxt(one + suffix),
                                       rtol=0, atol=1e-4)
        elif suffix.endswith(".ne_ind.txt"):
            np.testing.assert_allclose(np.loadtxt(two + suffix),
                                       np.loadtxt(one + suffix),
                                       rtol=1e-5, atol=1e-4)
    assert (_iteration_lines(runs["logs"]["two", name])
            == _iteration_lines(runs["logs"]["one", name]))
    assert _iteration_lines(runs["logs"]["one", name])


def test_streamed_cohort_equals_in_memory(runs):
    """Each rank streaming its own window gives what each rank parsing its
    window gives: byte for byte."""
    for suffix in (".pop_af.npy", ".ne_obs.npy", ".pop_like_LOO.tsv"):
        with open(runs["prefix"]("two", "stream") + suffix, "rb") as a, \
                open(runs["prefix"]("two", "head") + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def test_partition_of_a_site_does_not_depend_on_world(runs):
    """Partition p holds the sites with ``s % P == p`` of the global axis,
    whatever the number of ranks: each partition's sums agree."""
    suffix = ".pop_like_LOO_partitions_3.tsv.gz"
    got_df, got = _tsv_numbers(runs["prefix"]("two", "part") + suffix)
    want_df, want = _tsv_numbers(runs["prefix"]("one", "part") + suffix)
    assert got_df["data_part"].equals(want_df["data_part"])
    assert len(got) == 3 * N
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    # and the partitions differ from each other, so a shifted one would show
    assert np.abs(want[0::3] - want[1::3]).max() > 1.0


def test_model_iterations_and_values(runs):
    """Per population and per problem: equal EM iterations, two ranks and
    one, for the reference AF, every LOO problem and every reference
    z-score EM; equal loci; values to the module's tolerances."""
    one = np.load(runs["prefix"]("one", "model") + ".npz")
    two = np.load(runs["prefix"]("two", "model") + ".npz")
    for key in ("af_iters", "loo_iters", "loo_converged", "z_iters",
                "z_loci"):
        np.testing.assert_array_equal(two[key], one[key], err_msg=key)
    assert one["loo_iters"].shape == (N,) and one["z_iters"].min() > 0
    np.testing.assert_allclose(two["af"], one["af"], rtol=0, atol=1e-5)
    _assert_ll_close(two["loo_ll"], one["loo_ll"])
    np.testing.assert_allclose(two["z"], one["z"], rtol=0, atol=1e-4)


def test_model_iterations_equal_jax(files, runs):
    """The two ranks against the JAX package on one device, per problem."""
    import jax

    from wgsassign_tpu.io.beagle import read_beagle
    from wgsassign_tpu.io.ids import read_ids
    from wgsassign_tpu.models.common import to_device
    from wgsassign_tpu.models.loo import leave_one_out
    from wgsassign_tpu.models.reference_af import estimate_reference_af
    from wgsassign_tpu.parallel.mesh import make_runtime

    two = np.load(runs["prefix"]("two", "model") + ".npz")
    beagle, popmap = read_beagle(files["beagle"]), read_ids(files["ids"])
    cohort = to_device(beagle, make_runtime(jax.devices()[:1]))
    ref = estimate_reference_af(beagle, popmap, cohort=cohort)
    np.testing.assert_array_equal(two["af_iters"], ref.iters)
    loo = leave_one_out(beagle, ref.af, popmap, cohort=cohort)
    np.testing.assert_array_equal(two["loo_iters"], loo.iters)
    _assert_ll_close(two["loo_ll"], loo.ll)


def test_z_scores_are_loo_structured_on_several_ranks(runs):
    """Under --single_read_threshold the kept fraction (~0.27) picks the
    gathered EM on one rank; several ranks always take the loo-structured
    one, report it, and agree to the z tolerance with equal iterations."""
    one_log = runs["logs"]["one", "z_single"]
    two_log = runs["logs"]["two", "z_single"]
    assert "Reference z-score EM: gathered" in one_log
    assert "engine sites_chunk" in one_log
    assert "Reference z-score EM: loo-structured" in two_log
    assert "engine zloo_chunk" in two_log
    its = [re.search(r"iterations (\d+\.\.\d+)", log).group(1)
           for log in (one_log, two_log)]
    assert its[0] == its[1]
    got = np.loadtxt(runs["prefix"]("two", "z_single")
                     + ".reference_z_ind.txt")
    want = np.loadtxt(runs["prefix"]("one", "z_single")
                      + ".reference_z_ind.txt")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    two = np.load(runs["prefix"]("two", "model") + ".npz")
    assert str(two["z_structure"]) == "loo-structured"
    assert str(two["z_engine"]) == "zloo_chunk"


def test_rank_zero_alone_writes_and_prints(runs):
    """One set of files; the other rank prints nothing but the worker's own
    lines."""
    lines = [ln for ln in runs["logs"]["two_rank1"].splitlines()
             if ln and not ln.startswith("== command")]
    assert lines == ["ALL_COMMANDS_DONE"]
    args = open(runs["prefix"]("two", "head") + ".args").read()
    assert "-get_reference_af" in args and "-loo" in args
    assert "Mesh: 2 rank(s)" in runs["logs"]["two", "head"]
    assert "collectives over gloo" in runs["logs"]["two", "head"]


def test_devices_two_equals_the_environment_ranks(runs):
    """``--devices 2`` through ``main(..., device="cpu")`` starts the same
    two ranks: every file byte for byte."""
    env, dev = runs["prefix"]("two", "head"), runs["prefix"]("devices", "head")
    suffixes = sorted(p[len(env):] for p in glob.glob(env + ".*"))
    assert suffixes == sorted(p[len(dev):] for p in glob.glob(dev + ".*"))
    for suffix in suffixes:
        if suffix != ".args":  # timestamp, and the --devices flag
            with open(env + suffix, "rb") as a, open(dev + suffix, "rb") as b:
                assert a.read() == b.read(), suffix
    assert "-devices 2" in open(dev + ".args").read()


@pytest.mark.parametrize("resumed, writer", [("two", "one"), ("one", "two")])
def test_checkpoint_resumes_across_a_changed_world(runs, resumed, writer):
    """Restart files written under one number of ranks resume under the
    other: the EM state after 4 iterations gives the uninterrupted AF byte
    for byte, population 1's finished LOO is taken from its file, and the
    files are gone at the end."""
    prefix = runs["prefix"](resumed, "resume")
    want = np.load(runs["prefix"](resumed, "head") + ".pop_af.npy")
    np.testing.assert_array_equal(np.load(prefix + ".pop_af.npy"), want)
    log = runs["logs"][resumed, "resume"]
    assert _iteration_lines(log)[:K] == _iteration_lines(
        runs["logs"][resumed, "head"])[:K]
    assert "pop1: 10 problems, iterations 7..7 (engine: restart file)" in log
    assert not glob.glob(prefix + "*ckpt*")
    # the marker AF (0.3 everywhere) changes population 1's column only
    _, got = _tsv_numbers(prefix + ".pop_like_LOO.tsv")
    _, full = _tsv_numbers(runs["prefix"](resumed, "head")
                           + ".pop_like_LOO.tsv")
    np.testing.assert_array_equal(got[:, [0, 2]], full[:, [0, 2]])
    assert np.abs(got[:, 1] - full[:, 1]).max() > 1.0


def test_checkpoint_files_do_not_depend_on_world(files, tmp_path):
    """The same state saved by one rank has the layout the two ranks wrote
    (the JAX package's: site axis padded to a multiple of 128)."""
    worker = _worker_module()
    worker.write_checkpoints(files["beagle"], files["ids"],
                             str(tmp_path / "a"))
    with np.load(str(tmp_path / "a") + ".em.ckpt.npz") as z:
        assert z["f"].shape == (K, 640) and int(z["it"]) == 4
        assert set(z.files) == {"f", "iters", "active", "it"}
    with np.load(str(tmp_path / "a") + ".loo.ckpt.pop1.done.npz") as z:
        assert z["f"].shape == (10, M)


def test_failed_rank_fails_the_run(files, tmp_path):
    """``--devices 2`` with an input only found after the ranks start: the
    parent raises and leaves no process behind."""
    with pytest.raises(RuntimeError, match="rank"):
        torch_main(["--beagle", files["beagle"], "--pop_af_IDs",
                    str(tmp_path / "missing.txt"), "--get_reference_af",
                    "--devices", "2", "-o", str(tmp_path / "f")],
                   device="cpu")


def test_devices_under_the_environment_raises(files, tmp_path, monkeypatch):
    monkeypatch.setenv("WGSA_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("WGSA_NUM_PROCESSES", "2")
    monkeypatch.setenv("WGSA_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="--devices cannot be combined"):
        torch_main(["--beagle", files["beagle"], "--get_pop_like",
                    "--devices", "2", "-o", str(tmp_path / "e")],
                   device="cpu")


def test_process_windows_tile_the_site_axis():
    """Windows are contiguous, padded to the multiple, and cover every
    site once; a rank past the end gets an empty window."""
    from wgsassign_tpu_torch.io.beagle import process_row_range

    for m, mult, world in ((600, 1, 2), (600, 3, 4), (3, 4, 2), (5, 3, 2)):
        spans = [process_row_range(m, mult, r, world) for r in range(world)]
        per = spans[0][2]
        assert per % mult == 0 and per * world >= m
        assert [s[0] for s in spans] == [r * per for r in range(world)]
        assert sum(hi - lo for lo, hi, _ in spans) == m
        assert all(lo % mult == 0 for lo, _, _ in spans)
