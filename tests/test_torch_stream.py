"""The port's streamed ingest (``--stream_ingest``): the cohort built block
by block from the Beagle file is bit-identical to the in-memory
``to_device(read_beagle(path))``, for every block size, both readers, any
site multiple, any keep mask, and with parse/copy overlap on or off; and
the CLI's outputs from a streamed cohort are byte-identical to those of an
in-memory run.
"""

import gzip

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from wgsassign_tpu.io.beagle import BeagleData, read_beagle
from wgsassign_tpu.io.synth import synth_cohort, write_beagle
from wgsassign_tpu_torch.cli import main as torch_main
from wgsassign_tpu_torch.models import common
from wgsassign_tpu_torch.models.common import stream_to_device, to_device
from wgsassign_tpu_torch.parallel.runtime import make_runtime

M, N, K = 600, 30, 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=6)
    beagle = str(d / "cohort.beagle.gz")
    write_beagle(beagle, gl)
    ids = str(d / "ids.txt")
    with open(ids, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"Ind{i}\t{lab}\n")
    ad_path = str(d / "cohort.ad.txt")
    np.savetxt(ad_path, ad, fmt="%d")
    # a downsampled file over 80% of the sites, with other GLs
    gl_ds, _, _ = synth_cohort(M, N, n_pops=K, seed=7)
    full_ds = str(d / "full_ds.beagle.gz")
    write_beagle(full_ds, gl_ds)
    ds = str(d / "ds.beagle.gz")
    with gzip.open(full_ds, "rt") as src, gzip.open(ds, "wt") as dst:
        for i, line in enumerate(src):
            if i == 0 or i % 5:
                dst.write(line)
    return {"beagle": beagle, "ids": ids, "ad": ad_path, "ds": ds, "dir": d}


def _assert_same_cohort(got, want):
    assert got.m_real == want.m_real and got.m_pad == want.m_pad
    for name in ("g0", "g1", "site_weight"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b), name


@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("keep", ["all", "every_fifth_dropped"])
@pytest.mark.parametrize("site_multiple", [1, 4])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("block_rows", [7, 64, 10_000])
def test_streamed_cohort_bitmatches_in_memory(files, monkeypatch, block_rows,
                                             use_native, site_multiple, keep,
                                             overlap):
    monkeypatch.setenv("WGSA_STREAM_OVERLAP", overlap)
    rt = make_runtime("cpu")
    full = read_beagle(files["beagle"])
    keep_mask = None
    if keep != "all":
        keep_mask = np.arange(M) % 5 != 0
        rows = np.flatnonzero(keep_mask)
        full = BeagleData(full.gl[rows], full.sample_names,
                          [full.site_names[r] for r in rows])
    cohort, meta, names = stream_to_device(
        files["beagle"], rt, site_multiple=site_multiple,
        block_rows=block_rows, use_native=use_native,
        collect_site_names=True, keep_mask=keep_mask,
    )
    _assert_same_cohort(cohort, to_device(full, rt,
                                          site_multiple=site_multiple))
    assert (meta.n_sites, meta.n_inds) == (M, N)
    assert meta.sample_names == full.sample_names
    assert names == full.site_names


def test_overlap_rule_keeps_the_jax_package_semantics(monkeypatch):
    for env, want in (("0", False), ("false", False), ("False", False),
                      ("1", True), ("yes", True)):
        monkeypatch.setenv("WGSA_STREAM_OVERLAP", env)
        assert common._stream_overlap_default() is want
    monkeypatch.delenv("WGSA_STREAM_OVERLAP")
    monkeypatch.setattr(common.os, "cpu_count", lambda: 2)
    assert common._stream_overlap_default() is False
    monkeypatch.setattr(common.os, "cpu_count", lambda: 8)
    assert common._stream_overlap_default() is True


@pytest.mark.parametrize("env, want", [
    ("0", False), ("false", False), ("no", False), ("off", False),
    ("FALSE", False), ("No", False), ("OFF", False), (" Off ", False),
    ("1", True), ("true", True), ("TRUE", True), ("on", True),
])
def test_overlap_reads_off_words_in_any_case(monkeypatch, env, want):
    """``0``, ``false``, ``no`` and ``off`` in any case mean off (the JAX
    package reads only ``0``, ``false`` and ``False`` as off)."""
    monkeypatch.setenv("WGSA_STREAM_OVERLAP", env)
    assert common._stream_overlap_default() is want


def test_keep_mask_must_cover_the_file(files):
    with pytest.raises(ValueError, match="keep_mask covers"):
        stream_to_device(files["beagle"], make_runtime("cpu"),
                         keep_mask=np.ones(M - 1, bool))


CLI_CONFIGS = {
    "reference_af_loo": (["--get_reference_af", "--ne_obs", "--loo"],
                         [".pop_af.npy", ".pop_names.txt",
                          ".pop_like_LOO.tsv", ".fisher_obs.npy",
                          ".ne_obs.npy", ".ne_obs.txt", ".ne_ind.txt"]),
    "downsampled_loo": (["--get_reference_af", "--loo",
                         "--loo_downsampled_beagle", "{ds}",
                         "--partition_sites", "3"],
                        [".pop_af.npy", ".pop_like_LOO_downsampled.tsv",
                         ".pop_like_LOO_downsampled_partitions_3.tsv.gz"]),
    "reference_z_score": (["--get_reference_z_score", "--ind_ad_file",
                           "{ad}", "--pop_names", "{ids}"],
                          [".reference_z_ind.txt"]),
}


def _read(path):
    if path.endswith(".gz"):  # the gzip header holds a time stamp
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("config", sorted(CLI_CONFIGS))
def test_streamed_cli_outputs_equal_in_memory(files, config):
    flags, suffixes = CLI_CONFIGS[config]
    flags = [f.format(**files) for f in flags]
    prefixes = {}
    for mode, extra in (("memory", []), ("stream", ["--stream_ingest", "50"])):
        prefix = str(files["dir"] / f"{config}_{mode}")
        torch_main(["--beagle", files["beagle"], "--pop_af_IDs",
                    files["ids"], "-o", prefix, *flags, *extra],
                   device="cpu")
        prefixes[mode] = prefix
    for suffix in suffixes:
        assert (_read(prefixes["stream"] + suffix)
                == _read(prefixes["memory"] + suffix)), suffix


def test_z_tables_of_a_streamed_cohort_equal_in_memory(files):
    """Under streamed ingest the z-score tables are built from the device
    cohort and the uploaded depths alone: the same tables, kept sites and
    counts as from the in-memory cohort (padded to 8 sites)."""
    from wgsassign_tpu_torch.io.ad import read_allele_depths
    from wgsassign_tpu_torch.models.common import upload_allele_depths
    from wgsassign_tpu_torch.models.zscore import build_tables

    rt = make_runtime("cpu")
    beagle = read_beagle(files["beagle"])
    ad = read_allele_depths(files["ad"], n_sites=M, n_inds=N)
    built = []
    for cohort in (to_device(beagle, rt),
                   stream_to_device(files["beagle"], rt, site_multiple=8)[0]):
        built.append(build_tables(cohort, upload_allele_depths(ad, cohort),
                                  3, 29, 0, False))
    mem, streamed = built
    for name in ("combos", "mean_gl", "read_probs", "rows_by_depth"):
        assert torch.equal(getattr(mem, name), getattr(streamed, name)), name
    assert torch.equal(mem.mask, streamed.mask[:, :M])
    assert not streamed.mask[:, M:].any()
    for name in ("n_rows", "s_local", "s_glob"):
        np.testing.assert_array_equal(getattr(mem, name),
                                      getattr(streamed, name))

