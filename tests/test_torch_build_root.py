"""Where the port builds its native code (``wgsassign_tpu_torch/
compile_cache.py``): ``WGSA_COMPILE_CACHE`` unset keeps the checkout's
``build/``, a directory moves the kernel library and the Beagle reader
under it, and ``off`` / ``0`` / ``none`` build in a directory of the process
that is gone once it exits.  The variable is read when a build runs, so
these tests set it after the modules were imported.  On the CPU nothing
compiles the CUDA kernels; their path is checked, and the g++ build of the
reader really runs.
"""

import ctypes
import logging
import os
import subprocess
import sys

import pytest

from wgsassign_tpu.io.synth import synth_cohort, write_beagle
from wgsassign_tpu_torch import _kernels, _native, compile_cache
from wgsassign_tpu_torch.cli import main as torch_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT_BUILD = os.path.join(ROOT, "build")


def _under(path, root):
    return os.path.commonpath([str(path), str(root)]) == str(root)


@pytest.mark.parametrize("value", [None, ""])
def test_unset_builds_in_the_checkout(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("WGSA_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("WGSA_COMPILE_CACHE", value)
    assert str(compile_cache.build_base()) == CHECKOUT_BUILD
    native = _native.library_path()
    kernels = _kernels.library_path()
    assert native.parent.parent == (
        compile_cache.CHECKOUT_BUILD / "wgsassign_tpu_torch_native")
    assert str(kernels.parent.parent) == os.path.join(
        CHECKOUT_BUILD, "wgsassign_tpu_torch_kernels")
    assert native.name == "libbeagle_reader.so"
    assert kernels.name == "libwgsassign_kernels.so"


def test_a_directory_moves_both_builds(monkeypatch, tmp_path):
    monkeypatch.setenv("WGSA_COMPILE_CACHE", str(tmp_path))
    kernels = _kernels.library_path()
    assert kernels.parent.parent == tmp_path / "wgsassign_tpu_torch_kernels"
    native = _native.library_path()
    assert native.parent.parent == tmp_path / "wgsassign_tpu_torch_native"
    path, seconds = _native.build()
    assert path == str(native) and native.exists() and seconds > 0.0
    assert _native.build() == (path, 0.0)  # built already: no compile
    assert ctypes.CDLL(path).beagle_read
    assert not [p for p in os.listdir(tmp_path / "wgsassign_tpu_torch_native"
                                      / native.parent.name)
                if p.endswith(".tmp")]


def test_the_readers_hash_covers_the_host(monkeypatch, tmp_path):
    """The reader is built with -march=native: two hosts of different CPUs
    that share a cache directory get a build each."""
    monkeypatch.setenv("WGSA_COMPILE_CACHE", str(tmp_path))
    here = _native.library_path()
    assert compile_cache.host_key() == compile_cache.host_key()
    monkeypatch.setattr(_native, "host_key", lambda: "another-cpu")
    there = _native.library_path()
    assert there != here and there.parent.parent == here.parent.parent
    # the CUDA library's host code is not built for the host's CPU
    kernels = _kernels.library_path()
    monkeypatch.undo()
    monkeypatch.setenv("WGSA_COMPILE_CACHE", str(tmp_path))
    assert _kernels.library_path() == kernels


@pytest.mark.parametrize("word", ["off", "OFF", "0", "none", "None"])
def test_off_words_give_a_directory_of_the_process(monkeypatch, word):
    monkeypatch.setenv("WGSA_COMPILE_CACHE", word)
    base = compile_cache.build_base()
    assert not _under(base, ROOT)
    assert str(os.getpid()) in base.name
    assert compile_cache.build_base() == base  # one per process
    assert _native.library_path().parent.parent == (
        base / "wgsassign_tpu_torch_native")
    assert _kernels.library_path().parent.parent == (
        base / "wgsassign_tpu_torch_kernels")


def test_off_builds_cold_and_removes_the_build_at_exit(tmp_path):
    code = (
        "from wgsassign_tpu_torch import _native, _kernels\n"
        "assert _native.native_available()\n"
        "lib = _native.library_path()\n"
        "assert lib.exists()\n"
        "assert lib.parent.parent.parent == "
        "_kernels.library_path().parent.parent.parent\n"
        "print(lib)\n"
    )
    env = dict(os.environ, WGSA_COMPILE_CACHE="off", TMPDIR=str(tmp_path),
               PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    lib = run.stdout.strip().splitlines()[-1]
    assert _under(lib, tmp_path)
    assert not os.path.exists(lib)
    assert os.listdir(tmp_path) == []  # the process's directory went too


def test_the_cli_logs_the_build_root(monkeypatch, tmp_path, caplog):
    monkeypatch.setenv("WGSA_COMPILE_CACHE", str(tmp_path / "cache"))
    # the reader this run loads from tmp_path is not kept for later tests
    monkeypatch.setattr(_native, "_lib", None)
    gl, labels, _ = synth_cohort(40, 6, n_pops=2, seed=4)
    beagle = str(tmp_path / "c.beagle.gz")
    write_beagle(beagle, gl)
    ids = tmp_path / "ids.txt"
    ids.write_text("".join(f"Ind{i}\t{lab}\n" for i, lab in
                           enumerate(labels)))
    with caplog.at_level(logging.INFO, logger="wgsassign_tpu"):
        torch_main(["--beagle", beagle, "--pop_af_IDs", str(ids),
                    "--get_reference_af", "--maf_iter", "2", "--log_level",
                    "INFO", "-o", str(tmp_path / "out")], device="cpu")
    assert any(str(tmp_path / "cache") in r.getMessage()
               for r in caplog.records)
    assert (tmp_path / "out.pop_af.npy").exists()
