"""The port's own host modules (``wgsassign_tpu_torch/io``, ``_native``,
``obs``, the argparse ``parser``) against the JAX package's, which they were
copied from: the same inputs, made from a numpy seed through ``synth``, must
give equal arrays (exact, not a tolerance: it is the same code) and
byte-identical files.  Also here: the port imports nothing of
``wgsassign_tpu`` and nothing of ``jax``, by a source scan and in a fresh
interpreter that imports every module and runs every analysis of the CLI.
"""

import argparse
import ast
import gzip
import io
import logging
import os
import pkgutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import wgsassign_tpu.cli as jcli
import wgsassign_tpu.io.ad as jad
import wgsassign_tpu.io.beagle as jbeagle
import wgsassign_tpu.io.ids as jids
import wgsassign_tpu.io.plink as jplink
import wgsassign_tpu.io.stream as jstream
import wgsassign_tpu.io.synth as jsynth
import wgsassign_tpu.io.writers as jwriters
import wgsassign_tpu.obs.log as jlog
import wgsassign_tpu.obs.profiling as jprof
import wgsassign_tpu_torch
import wgsassign_tpu_torch.cli as tcli
import wgsassign_tpu_torch.io.ad as tad
import wgsassign_tpu_torch.io.beagle as tbeagle
import wgsassign_tpu_torch.io.ids as tids
import wgsassign_tpu_torch.io.plink as tplink
import wgsassign_tpu_torch.io.stream as tstream
import wgsassign_tpu_torch.io.synth as tsynth
import wgsassign_tpu_torch.io.writers as twriters
import wgsassign_tpu_torch.obs.log as tlog
import wgsassign_tpu_torch.obs.profiling as tprof
from wgsassign_tpu.obs.checkpoint import save_npz_atomic as jsave_npz
from wgsassign_tpu_torch import _native as tnative
from wgsassign_tpu_torch import compile_cache
from wgsassign_tpu_torch.obs.checkpoint import save_npz_atomic as tsave_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, K = 300, 12, 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    gl, labels, ad = jsynth.synth_cohort(M, N, n_pops=K, seed=5)
    beagle = str(d / "c.beagle.gz")
    jsynth.write_beagle(beagle, gl)
    ids = str(d / "ids.txt")
    with open(ids, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"Ind{i}\t{lab}\n")
    ad_txt = str(d / "c.ad.txt")
    np.savetxt(ad_txt, ad, fmt="%d")
    ad_gz = str(d / "c.ad.txt.gz")
    with gzip.open(ad_gz, "wt") as f:
        np.savetxt(f, ad, fmt="%d")
    # every fifth site dropped: the downsampled file of the intersection
    ds = str(d / "ds.beagle.gz")
    with gzip.open(beagle, "rt") as src, gzip.open(ds, "wt") as dst:
        for i, line in enumerate(src):
            if i == 0 or i % 5:
                dst.write(line)
    pop_names = str(d / "pops.txt")
    np.savetxt(pop_names, np.unique(labels), fmt="%s")
    return {"dir": d, "beagle": beagle, "ids": ids, "ad": ad_txt,
            "ad_gz": ad_gz, "ds": ds, "pop_names": pop_names, "gl": gl,
            "labels": labels, "ad_arr": ad}


def _same_beagle(got, want):
    assert got.gl.dtype == want.gl.dtype == np.float32
    np.testing.assert_array_equal(got.gl, want.gl)
    assert list(got.sample_names) == list(want.sample_names)
    assert list(got.site_names) == list(want.site_names)


def test_native_reader_is_built_outside_the_package():
    assert tnative.native_available()
    lib = tnative.library_path()
    assert lib.exists()
    assert lib.parent.parent == (compile_cache.CHECKOUT_BUILD
                                 / tnative.BUILD_NAME)
    assert os.path.join("build", "wgsassign_tpu_torch_native") in str(lib)
    pkg = os.path.dirname(tnative.__file__)
    assert not [p for p in os.listdir(pkg) if p.endswith(".so")]


LITTLE_ENDIAN_GATE = ("#if defined(__BYTE_ORDER__) && "
                      "__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__")


def test_native_source_is_the_jax_packages():
    """The port's reader is the JAX package's but for the little-endian
    gate around the SWAR digit parse (its helpers and both call sites):
    only ``#if`` / ``#endif`` lines are added, nothing else changes."""
    with open(os.path.join(ROOT, "wgsassign_tpu", "_native",
                           "beagle_reader.cpp")) as f:
        want = f.read().splitlines()
    with open(os.path.join(os.path.dirname(tnative.__file__),
                           "beagle_reader.cpp")) as f:
        got = f.read().splitlines()
    added = [ln for ln in got if ln in (LITTLE_ENDIAN_GATE, "#endif")]
    assert added == [LITTLE_ENDIAN_GATE, "#endif"] * 3
    assert [ln for ln in got if ln not in added] == want
    swar = [i for i, ln in enumerate(got)
            if "is_8_digits(" in ln or "parse_8_digits(" in ln
            or "load_u64(" in ln]
    gates = [(i, got.index("#endif", i)) for i, ln in enumerate(got)
             if ln == LITTLE_ENDIAN_GATE]
    assert swar and all(any(a < i < b for a, b in gates) for i in swar)


def test_general_digit_loop_parses_like_the_jax_package(files, tmp_path,
                                                       monkeypatch):
    """The reader built as for a target that is not little-endian
    (``-U__BYTE_ORDER__``: the gate is closed, every token takes the
    general digit loop) parses the JAX package's arrays."""
    lib = tmp_path / "libbeagle_reader.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    "-U__BYTE_ORDER__", str(tnative._SRC), "-o", str(lib),
                    "-lz", "-lpthread"], check=True, timeout=300)
    monkeypatch.setattr(tnative, "library_path", lambda: lib)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    got = tnative.read_beagle_native(files["beagle"])
    assert tnative._lib is not None and tnative._lib._name == str(lib)
    _same_beagle(got, jbeagle.read_beagle(files["beagle"]))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("row_range", [None, (0, 0), (7, 123), (250, 400)])
def test_read_beagle_matches_jax(files, use_native, row_range):
    got = tbeagle.read_beagle(files["beagle"], use_native=use_native,
                              row_range=row_range)
    want = jbeagle.read_beagle(files["beagle"], use_native=use_native,
                               row_range=row_range)
    _same_beagle(got, want)
    assert type(got) is tbeagle.BeagleData


def test_read_beagle_parsers_agree(files):
    _same_beagle(tbeagle.read_beagle(files["beagle"], use_native=True),
                 tbeagle.read_beagle(files["beagle"], use_native=False))


def test_dims_cache_key_and_path_are_the_jax_packages(files, tmp_path,
                                                    monkeypatch):
    """Both packages share ``~/.cache/wgsassign_tpu/beagle_dims.json`` on
    purpose: one key, ``realpath|size|mtime_ns``, for the same row and
    column counts."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tbeagle._dims_cache_path() == jbeagle._dims_cache_path()
    assert tbeagle._dims_cache_path().startswith(str(tmp_path))
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tbeagle._dims_cache_path() == jbeagle._dims_cache_path()
    for path in (files["beagle"], files["ds"], str(tmp_path / "absent")):
        assert tbeagle._dims_cache_key(path) == jbeagle._dims_cache_key(path)
    key = tbeagle._dims_cache_key(files["beagle"])
    st = os.stat(files["beagle"])
    assert key == (f"{os.path.realpath(files['beagle'])}|{st.st_size}|"
                   f"{st.st_mtime_ns}")


@pytest.mark.parametrize("use_native", [True, False])
def test_beagle_dims_matches_jax(files, use_native, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    want = jbeagle._beagle_dims_scan(files["beagle"], use_native)
    assert tbeagle._beagle_dims_scan(files["beagle"], use_native) == want
    assert want == (M, N)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_dims_cache_is_shared(files, writer, reader, tmp_path, monkeypatch):
    """One cache file, one key: what one package wrote, the other reads
    without scanning."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    mods = {"jax": jbeagle, "torch": tbeagle}
    assert jbeagle._dims_cache_path() == tbeagle._dims_cache_path()
    assert mods[writer].beagle_dims(files["beagle"]) == (M, N)

    def no_scan(*a, **k):
        raise AssertionError("the cache entry was not found")

    monkeypatch.setattr(mods[reader], "_beagle_dims_scan", no_scan)
    assert mods[reader].beagle_dims(files["beagle"]) == (M, N)


def test_ids_match_jax(files):
    got, want = tids.read_ids(files["ids"]), jids.read_ids(files["ids"])
    for field in ("sample_names", "pop_labels", "pops", "pop_index",
                  "membership"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(got.pop_sizes, want.pop_sizes)
    np.testing.assert_array_equal(got.members_of("pop1"),
                                  want.members_of("pop1"))
    pm = tids.population_map(want.sample_names, want.pop_labels)
    np.testing.assert_array_equal(pm.pop_index, want.pop_index)
    np.testing.assert_array_equal(tids.read_pop_names(files["pop_names"]),
                                  jids.read_pop_names(files["pop_names"]))


@pytest.mark.parametrize("which", ["ad", "ad_gz"])
def test_allele_depths_match_jax(files, which):
    got = tad.read_allele_depths(files[which], n_sites=M, n_inds=N)
    want = jad.read_allele_depths(files[which], n_sites=M, n_inds=N)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, files["ad_arr"])


def test_allele_depth_errors_match_jax(files):
    for mod in (tad, jad):
        with pytest.raises(ValueError, match="individuals"):
            mod.read_allele_depths(files["ad"], n_inds=N + 1)
        with pytest.raises(ValueError, match="rows"):
            mod.read_allele_depths(files["ad"], n_sites=M + 1)


def test_majmin_counts_match_jax():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 9, (20, 4 * 5))
    codes = rng.integers(0, 4, (20, 2))
    np.testing.assert_array_equal(tad.extract_majmin_counts(raw, codes),
                                  jad.extract_majmin_counts(raw, codes))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("block_rows,row_range", [
    (64, None), (1000, None), (37, (10, 211)), (50, (290, 500))])
def test_block_iterator_matches_jax(files, use_native, block_rows, row_range):
    kw = dict(use_native=use_native, row_range=row_range, dims=(M, N))
    meta_t, it_t = tstream.open_block_iterator(files["beagle"], block_rows,
                                               **kw)
    meta_j, it_j = jstream.open_block_iterator(files["beagle"], block_rows,
                                               **kw)
    assert (meta_t.n_sites, meta_t.n_inds, list(meta_t.sample_names)) == (
        meta_j.n_sites, meta_j.n_inds, list(meta_j.sample_names))
    blocks_t, blocks_j = list(it_t), list(it_j)
    assert len(blocks_t) == len(blocks_j) > 0
    for (gl_t, sites_t), (gl_j, sites_j) in zip(blocks_t, blocks_j):
        np.testing.assert_array_equal(gl_t, gl_j)
        assert sites_t == sites_j
    with pytest.raises(RuntimeError, match="site names"):
        meta_t.site_names


def test_prefetch_matches_jax(files):
    def blocks(mod):
        _, it = mod.open_block_iterator(files["beagle"], 41, dims=(M, N))
        return [gl for gl, _ in mod.prefetch(it)]

    for a, b in zip(blocks(tstream), blocks(jstream)):
        np.testing.assert_array_equal(a, b)

    def boom():
        yield from ()
        raise ValueError("parse error")

    with pytest.raises(ValueError, match="parse error"):
        list(tstream.prefetch(boom()))


def test_filter_sites_to_common_matches_jax(files):
    full_t = tbeagle.read_beagle(files["beagle"])
    full_j = jbeagle.read_beagle(files["beagle"])
    names = tbeagle.scan_site_names(files["ds"])
    assert names == jbeagle.scan_site_names(files["ds"])
    assert len(names) == M - M // 5
    with redirect_stdout(io.StringIO()) as out_t:
        got = tbeagle.filter_sites_to_common(full_t, names)
    with redirect_stdout(io.StringIO()) as out_j:
        want = jbeagle.filter_sites_to_common(full_j, names)
    _same_beagle(got, want)
    assert out_t.getvalue() == out_j.getvalue() != ""
    np.testing.assert_array_equal(tbeagle.to_legacy_matrix(got),
                                  jbeagle.to_legacy_matrix(want))


def test_hashed_intersection_matches_jax(files):
    assert (tbeagle.scan_header_samples(files["beagle"])
            == jbeagle.scan_header_samples(files["beagle"]))
    h_full = tbeagle.scan_site_hashes(files["beagle"])
    h_ds = tbeagle.scan_site_hashes(files["ds"], m=10)
    np.testing.assert_array_equal(h_full,
                                  jbeagle.scan_site_hashes(files["beagle"]))
    np.testing.assert_array_equal(h_ds, jbeagle.scan_site_hashes(files["ds"]))
    with redirect_stdout(io.StringIO()):
        got = tbeagle.site_intersection_masks_hashed(h_full, h_ds)
        want = jbeagle.site_intersection_masks_hashed(h_full, h_ds)
        by_name = tbeagle.site_intersection_masks(
            tbeagle.scan_site_names(files["beagle"]),
            tbeagle.scan_site_names(files["ds"]))
    for g, w, n in zip(got, want, by_name):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, n)
    assert int(got[0].sum()) == M - M // 5 and got[1].all()
    with pytest.raises(ValueError, match="No common sites"):
        tbeagle.site_intersection_masks_hashed(h_full, h_full + 1)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_reads_take_rank_and_world(files, world, tmp_path,
                                           monkeypatch):
    """The copies take the process index and count as arguments where the
    JAX package asks ``jax.process_count()``: the windows tile the file."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    full = tbeagle.read_beagle(files["beagle"])
    keep = np.arange(M) % 4 != 1
    shards = [tbeagle.read_beagle_sharded(files["beagle"], site_multiple=8,
                                          rank=r, world=world)
              for r in range(world)]
    assert all(s.m_global == M and s.rows_per_process % 8 == 0
               for s in shards)
    np.testing.assert_array_equal(
        np.concatenate([s.local.gl for s in shards]), full.gl)
    assert [s.lo for s in shards] == [r * shards[0].rows_per_process
                                      for r in range(world)]
    kept = [tbeagle.read_beagle_sharded_filtered(
        files["beagle"], keep, site_multiple=8, rank=r, world=world)
        for r in range(world)]
    np.testing.assert_array_equal(
        np.concatenate([s.local.gl for s in kept]), full.gl[keep])
    assert tbeagle.process_row_range(M, 8, 0, 1) == (0, M, 304)


def _write_all(mod, prefix, rng):
    af = rng.uniform(0.05, 0.95, (M, K))
    ll = rng.normal(-500.0, 30.0, (N, K))
    pops = [f"pop{j}" for j in range(K)]
    names = [f"Ind{i}" for i in range(N)]
    labels = [pops[i % K] for i in range(N)]
    mod.write_pop_af(prefix, af)
    mod.write_pop_names(prefix, pops)
    mod.write_loglike_txt(prefix, ll)
    mod.write_ne_outputs(prefix, af * 3.0, af * 7.0, pops)
    mod.write_ne_ind(prefix, rng.uniform(0.5, 3.0, N))
    mod.write_z_scores(prefix, rng.normal(size=N), reference_mode=True)
    mod.write_z_scores(prefix, rng.normal(size=N), reference_mode=False)
    mix = np.column_stack([pops, rng.dirichlet(np.ones(K), K).astype(str)])
    mod.write_mixture(prefix, mix, mcmc=False)
    mod.write_mixture(prefix, mix, mcmc=True)
    mod.write_assignment_matrix(
        prefix + ".pop_like_LOO.tsv", ll, names, pops,
        print_part_column=False, sample_locations=labels, doing_LOO=True)
    mod.write_assignment_matrix(
        prefix + ".parts.tsv", np.repeat(ll, 2, axis=0), names, pops,
        partition_count=2, sample_locations=labels)


WRITTEN = (".pop_af.npy", ".pop_names.txt", ".pop_like.txt",
           ".fisher_obs.npy", ".ne_obs.npy", ".ne_obs.txt", ".ne_ind.txt",
           ".reference_z_ind.txt", ".z_ind.txt", ".em_mix.txt",
           ".mcmc_mix.txt", ".pop_like_LOO.tsv", ".parts.tsv")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("writers")
    out = {}
    for pkg, mod in (("jax", jwriters), ("torch", twriters)):
        out[pkg] = str(d / pkg)
        _write_all(mod, out[pkg], np.random.default_rng(11))
    return out


@pytest.mark.parametrize("suffix", WRITTEN)
def test_writers_are_byte_identical(written, suffix):
    with open(written["jax"] + suffix, "rb") as a, \
            open(written["torch"] + suffix, "rb") as b:
        data = a.read()
        assert data and data == b.read()


def test_gzipped_assignment_matrix_matches_jax(tmp_path):
    ll = np.random.default_rng(2).normal(-90.0, 5.0, (4, 2))
    texts = []
    for pkg, mod in (("jax", jwriters), ("torch", twriters)):
        path = str(tmp_path / f"{pkg}.tsv.gz")
        mod.write_assignment_matrix(path, ll, list("abcd"), ["p", "q"])
        with gzip.open(path, "rt") as f:
            texts.append(f.read())
    assert texts[0] == texts[1] != ""


def test_args_file_matches_jax(tmp_path):
    argv = ["--beagle", "x.beagle.gz", "--get_reference_af", "--loo",
            "--maf_iter", "50", "-o", "run"]
    lines = []
    for pkg, mod, cli in (("jax", jwriters, jcli), ("torch", twriters, tcli)):
        path = mod.write_args_file(str(tmp_path / pkg),
                                   cli.parser.parse_args(argv),
                                   cli.parser.parse_args([]))
        with open(path) as f:
            rows = f.read().splitlines()
        lines.append([r for r in rows if not r.startswith("Time: ")])
    assert lines[0] == lines[1]
    assert "\t-maf_iter 50" in lines[1] and "\t-loo" in lines[1]


def test_writers_write_on_rank_zero_only(tmp_path):
    """The port's primary check is the rank it is given (the JAX package
    asks ``jax.process_index()``)."""
    af = np.full((3, 2), 0.5, np.float32)
    assert twriters.write_pop_af(str(tmp_path / "r1"), af, rank=1) is None
    assert not os.path.exists(tmp_path / "r1.pop_af.npy")
    path = twriters.write_pop_af(str(tmp_path / "r0"), af, rank=0)
    assert path == str(tmp_path / "r0.pop_af.npy") and os.path.exists(path)


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_cohort_matches_jax(seed):
    got = tsynth.synth_cohort(200, 9, n_pops=3, seed=seed)
    want = jsynth.synth_cohort(200, 9, n_pops=3, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["synth_beagle_file", "write_beagle"])
def test_synth_files_are_byte_identical(writer, tmp_path):
    paths = []
    for pkg, mod in (("jax", jsynth), ("torch", tsynth)):
        path = str(tmp_path / f"{pkg}.beagle.gz")
        if writer == "synth_beagle_file":
            mod.synth_beagle_file(path, 250, 6, n_pops=2, seed=4, chunk=100)
        else:
            gl, _, _ = mod.synth_cohort(60, 6, n_pops=2, seed=4)
            mod.write_beagle(path, gl)
        paths.append(path)
    with gzip.open(paths[0], "rb") as a, gzip.open(paths[1], "rb") as b:
        data = a.read()
        assert data and data == b.read()


def _write_bed(prefix, geno):
    """A SNP-major PLINK fileset for ``geno [M, N]`` (0, 1, 2, 9)."""
    m, n = geno.shape
    code = {2: 0b00, 9: 0b01, 1: 0b10, 0: 0b11}
    body = np.zeros((m, (n + 3) // 4), np.uint8)
    for s in range(m):
        for i in range(n):
            body[s, i // 4] |= code[int(geno[s, i])] << (2 * (i % 4))
    with open(prefix + ".bed", "wb") as f:
        f.write(b"\x6c\x1b\x01" + body.tobytes())
    with open(prefix + ".bim", "w") as f:
        for s in range(m):
            f.write(f"chr1\trs{s}\t0\t{100 + s}\tA\tG\n")
    with open(prefix + ".fam", "w") as f:
        for i in range(n):
            f.write(f"fam{i}\tInd{i}\t0\t0\t0\t-9\n")


@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_plink_matches_jax(tmp_path, error_rate):
    geno = np.random.default_rng(8).choice([0, 1, 2, 9], size=(17, 7))
    prefix = str(tmp_path / "p")
    _write_bed(prefix, geno)
    got = tplink.read_plink_bed(prefix, error_rate)
    _same_beagle(got, jplink.read_plink_bed(prefix, error_rate))
    assert type(got) is tbeagle.BeagleData


def _action_rows(parser):
    return [(a.option_strings, a.dest, a.default, a.help, a.metavar,
             a.type, a.nargs, a.const, a.required, type(a))
            for a in parser._actions]


def test_parser_is_its_own_copy():
    assert tcli.parser is not jcli.parser
    assert isinstance(tcli.parser, argparse.ArgumentParser)
    assert tcli.parser.prog == jcli.parser.prog
    assert len(tcli.parser._actions) > 40


@pytest.mark.parametrize("index", range(len(jcli.parser._actions)))
def test_parser_option_matches_jax(index):
    """Same option strings, defaults, help, metavar, type and action."""
    assert (_action_rows(tcli.parser)[index]
            == _action_rows(jcli.parser)[index])


def test_parser_help_and_defaults_match_jax():
    assert tcli.parser.format_help() == jcli.parser.format_help()
    assert vars(tcli.parser.parse_args([])) == vars(jcli.parser.parse_args([]))
    argv = ["-b", "f.gz", "-t", "3", "--stream_ingest", "0", "--loo",
            "--partition_sites", "4", "--mcmc_seed", "9", "--f32_sums"]
    assert (vars(tcli.parser.parse_args(argv))
            == vars(jcli.parser.parse_args(argv)))


def test_version_matches_jax():
    import wgsassign_tpu

    assert wgsassign_tpu_torch.__version__ == wgsassign_tpu.__version__


@pytest.mark.parametrize("mod", [tprof, jprof], ids=["torch", "jax"])
def test_run_timer(mod, capsys):
    """Both packages' ``RunTimer``: phases accumulate and count, also when
    the block raises, and the report lists the longest first."""
    timer = mod.RunTimer()
    timer.report()
    assert capsys.readouterr().out == ""
    for _ in range(2):
        with timer.phase("parse"):
            pass
    with pytest.raises(KeyError):
        with timer.phase("loo"):
            raise KeyError("x")
    timer.totals["loo"] += 5.0
    assert timer.counts == {"parse": 2, "loo": 1}
    assert timer.totals["parse"] >= 0.0
    timer.report()
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "-- timing summary --"
    assert lines[2].split()[0] == "loo" and lines[2].endswith("(1x)")
    assert lines[3].split()[0] == "parse" and lines[3].endswith("(2x)")


def test_run_timer_reports_alike(capsys):
    outs = []
    for mod in (tprof, jprof):
        timer = mod.RunTimer()
        timer.totals.update(parse=1.25, h2d=0.5)
        timer.counts.update(parse=1, h2d=3)
        timer.report()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] != ""


@pytest.mark.parametrize("level,env,want", [
    ("debug", None, logging.DEBUG), (None, "info", logging.INFO),
    (None, None, logging.WARNING), ("ERROR", "debug", logging.ERROR)])
def test_setup_logging_matches_jax(level, env, want, monkeypatch):
    """One logger name for both packages (the CLI output depends on it),
    the level from the argument or ``WGSA_LOG_LEVEL``."""
    if env is None:
        monkeypatch.delenv("WGSA_LOG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("WGSA_LOG_LEVEL", env)
    assert tlog.logger is jlog.logger
    assert tlog.logger.name == "wgsassign_tpu"
    before = (jlog.logger.level, list(jlog.logger.handlers))
    try:
        for mod in (jlog, tlog):
            got = mod.setup_logging(level)
            assert got is jlog.logger
            assert got.level == want and got.propagate
    finally:
        jlog.logger.setLevel(before[0])
        jlog.logger.handlers[:] = before[1]


def test_port_runtime_logs_to_the_same_logger():
    from wgsassign_tpu_torch.parallel import runtime

    assert runtime.log is tlog.logger


def test_save_npz_atomic_matches_jax(tmp_path):
    arrays = {"f": np.arange(6.0).reshape(2, 3), "it": np.asarray(4)}
    for name, fn in (("j.npz", jsave_npz), ("t.npz", tsave_npz)):
        fn(str(tmp_path / name), **arrays)
    assert sorted(os.listdir(tmp_path)) == ["j.npz", "t.npz"]
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def _imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _port_sources():
    pkg = os.path.join(ROOT, "wgsassign_tpu_torch")
    found = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    return sorted(found) + [os.path.join(ROOT, "chip_smoke.py"),
                            os.path.join(ROOT, "tests", "test_torch_cuda.py")]


def test_source_scan_finds_every_module():
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for want in ("wgsassign_tpu_torch/cli.py",
                 "wgsassign_tpu_torch/io/beagle.py",
                 "wgsassign_tpu_torch/_native/__init__.py",
                 "wgsassign_tpu_torch/obs/log.py", "chip_smoke.py"):
        assert want in rel


@pytest.mark.parametrize(
    "rel", [os.path.relpath(p, ROOT) for p in _port_sources()])
def test_no_import_of_jax_or_the_jax_package(rel):
    """No ``import``/``from`` of ``jax`` or ``wgsassign_tpu`` in the port,
    in ``chip_smoke.py`` or in the card's test file (naming the JAX
    package's files in comments is not importing them)."""
    bad = [n for n in _imports_of(os.path.join(ROOT, rel))
           if n.split(".")[0] in ("jax", "jaxlib", "wgsassign_tpu")]
    assert not bad, bad


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        wgsassign_tpu_torch.__path__, "wgsassign_tpu_torch."))


def test_every_module_and_analysis_without_jax(files, tmp_path):
    """A fresh interpreter imports every module of the port, then runs
    every analysis of the CLI on the CPU (reference AF + Ne + LOO with
    streamed ingest and the downsampled intersection, in-memory LOO,
    z-scores in both modes, pop_like, the mixture): neither ``jax`` nor any
    module of ``wgsassign_tpu`` is loaded at the end."""
    modules = _port_modules()
    assert "wgsassign_tpu_torch.io.plink" in modules
    assert "wgsassign_tpu_torch._native" in modules
    sub = str(tmp_path / "sub")
    runs = [
        ["--beagle", files["beagle"], "--pop_af_IDs", files["ids"],
         "--get_reference_af", "--ne_obs", "--loo", "--stream_ingest", "64",
         "--loo_downsampled_beagle", files["ds"], "--debug_checks",
         "--em_checkpoint", "-o", sub + "_s"],
        ["--beagle", files["beagle"], "--pop_af_IDs", files["ids"],
         "--get_reference_af", "--loo", "--partition_sites", "2",
         "--loo_downsampled_beagle", files["ds"], "-o", sub + "_d"],
        ["--beagle", files["beagle"], "--pop_af_IDs", files["ids"],
         "--get_reference_af", "--loo", "--profile", str(tmp_path / "trace"),
         "-o", sub],
        ["--beagle", files["beagle"], "--pop_af_IDs", files["ids"],
         "--ind_ad_file", files["ad"], "--pop_names", sub + ".pop_names.txt",
         "--pop_af_file", sub + ".pop_af.npy", "--get_reference_z_score",
         "--get_assignment_z_score", "-o", sub],
        ["--beagle", files["beagle"], "--get_pop_like", "--pop_af_file",
         sub + ".pop_af.npy", "-o", sub],
        ["--pop_like", sub + ".pop_like.txt", "--pop_like_IDs", files["ids"],
         "--get_em_mix", "--get_mcmc_mix", "-o", sub],
    ]
    code = (
        "import importlib, sys, torch\n"
        "torch.set_num_threads(1)\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from wgsassign_tpu_torch.cli import main\n"
        f"for argv in {runs!r}:\n"
        "    main(argv, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'wgsassign_tpu'))\n"
        "assert not bad, bad\n"
        "print('PORT_STANDS_ALONE')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT_STANDS_ALONE" in proc.stdout
    for suffix in (".pop_like_LOO.tsv", "_s.ne_ind.txt",
                   "_s.pop_like_LOO_downsampled.tsv",
                   "_d.pop_like_LOO_downsampled_partitions_2.tsv.gz",
                   ".reference_z_ind.txt", ".z_ind.txt", ".pop_like.txt",
                   ".em_mix.txt", ".mcmc_mix.txt"):
        assert os.path.exists(sub + suffix), suffix
