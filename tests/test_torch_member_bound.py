"""The kernels' member bounds (908, 908, 907 members) are where staging in
shared memory ends, not where the kernels end: a larger population goes
through the same chunked EM and the same kernel wrapper, whose launch
geometry then asks for the kernel's unstaged form.  The models never leave
the chunked EM for a shape; only ``--no_pallas`` runs the plain EM ops, and
the result says which engine ran.

The bounds are patched low so that a 600 x 30 x 3 cohort goes above them.
Each result is held against the JAX package's plain path (a one-device
runtime with ``use_pallas=False``): equal EM iterations; LOO
log-likelihoods rtol 1e-5, atol 2e-3 with identical argmax; z atol 1e-4 with
equal loci.
"""

import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

from wgsassign_tpu.io.beagle import BeagleData
from wgsassign_tpu.io.ids import population_map
from wgsassign_tpu.io.synth import synth_cohort
from wgsassign_tpu.parallel.mesh import make_runtime as jax_runtime
from wgsassign_tpu_torch import _kernels
from wgsassign_tpu_torch.models import loo as tloo
from wgsassign_tpu_torch.models import zscore as tz
from wgsassign_tpu_torch.models.common import to_device
from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
from wgsassign_tpu_torch.ops import loo_chunk as loo_mod
from wgsassign_tpu_torch.ops import sites_chunk as sites_mod
from wgsassign_tpu_torch.ops import zloo_chunk as zloo_mod
from wgsassign_tpu_torch.parallel.runtime import make_runtime

M, N, K = 600, 30, 3


@pytest.fixture(scope="module")
def data():
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=5)
    # uneven populations: 14, 10 and 6 members
    labels = np.asarray(["a"] * 14 + ["b"] * 10 + ["c"] * 6)
    beagle = BeagleData(gl, [f"Ind{i}" for i in range(N)],
                        [f"s_{i}" for i in range(M)])
    return beagle, population_map(beagle.sample_names, labels), ad


@pytest.fixture(scope="module")
def jax_plain(data):
    """The JAX package with its kernels off, on one device."""
    from wgsassign_tpu.models.loo import leave_one_out
    from wgsassign_tpu.models.reference_af import (
        estimate_reference_af as jax_ref_af,
    )

    beagle, popmap, _ = data
    rt = jax_runtime(jax.devices()[:1], use_pallas=False)
    ref = jax_ref_af(beagle, popmap, runtime=rt)
    loo = leave_one_out(beagle, ref.af, popmap, runtime=rt)
    return rt, ref, loo


@pytest.fixture
def logged(caplog):
    caplog.set_level(logging.WARNING, logger="wgsassign_tpu")
    logger = logging.getLogger("wgsassign_tpu")
    logger.addHandler(caplog.handler)  # the package's logger may not propagate
    yield caplog
    logger.removeHandler(caplog.handler)


def _warnings(caplog):
    # a record that reached the handler twice (directly and by propagation)
    # counts once
    records = {id(r): r for r in caplog.records
               if r.levelno == logging.WARNING}
    return [r.getMessage() for r in records.values()]


@pytest.mark.parametrize("bound, unstaged", [
    (10, ("a",)), (5, ("a", "b", "c")), (14, ())])
def test_loo_above_the_bound_stays_in_the_chunked_em(data, jax_plain,
                                                     monkeypatch, logged,
                                                     bound, unstaged):
    """Every population reaches the chunk wrapper with its own size; those
    above the staging bound get the unstaged launch geometry, no warning and
    the same engine."""
    beagle, popmap, _ = data
    _, ref, loo_ref = jax_plain
    monkeypatch.setattr(loo_mod, "max_loo_members", lambda: bound)
    seen = []

    def spy(g0p, g1p, ft, limits, n_real, T, fast_math=True):
        seen.append(n_real)
        return loo_mod.loo_chunk_twin(g0p, g1p, ft, limits, n_real, T,
                                      fast_math)

    cohort = to_device(beagle, make_runtime("cpu"))
    res = tloo.leave_one_out(beagle, ref.af, popmap, cohort=cohort,
                             chunk_op=spy)
    assert res.engines == ("loo_chunk",) * K
    assert not _warnings(logged)
    assert sorted(set(seen)) == sorted(int(n) for n in popmap.pop_sizes)
    for pop, size in zip(popmap.pops, popmap.pop_sizes):
        warps, smem = loo_mod.loo_chunk_geometry(int(size))
        assert (smem == 0) == (pop in unstaged)
        assert 1 <= warps <= loo_mod.LOO_MAX_WARPS
    np.testing.assert_array_equal(res.iters, loo_ref.iters)
    np.testing.assert_array_equal(res.converged, loo_ref.converged)
    np.testing.assert_allclose(res.ll, loo_ref.ll, rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(res.ll.argmax(1), loo_ref.ll.argmax(1))


@pytest.mark.parametrize("use_kernels, engine", [
    (False, "plain"), (True, "loo_chunk"), (None, "loo_chunk")])
def test_use_kernels_picks_the_engine(data, jax_plain, logged, use_kernels,
                                      engine):
    """``Runtime.use_kernels`` False (--no_pallas) runs the plain ops with no
    warning; True (--use_pallas) and the default (None: not passed) the
    chunked EMs."""
    beagle, popmap, _ = data
    _, ref, loo_ref = jax_plain
    kw = {} if use_kernels is None else {"use_kernels": use_kernels}
    rt = make_runtime("cpu", **kw)
    assert rt.use_kernels is (engine != "plain")
    before = dict(_kernels.launches)
    rt.load_kernels()  # the CPU builds, probes and launches nothing
    assert dict(_kernels.launches) == before
    cohort = to_device(beagle, rt)
    af = estimate_reference_af(beagle, popmap, cohort=cohort)
    assert af.engine == ("plain" if engine == "plain" else "em_chunk")
    np.testing.assert_array_equal(af.iters, ref.iters)
    np.testing.assert_allclose(af.af, ref.af, rtol=0, atol=1e-5)
    res = tloo.leave_one_out(beagle, af.af, popmap, cohort=cohort,
                             af_t_dev=af.af_t_dev)
    assert res.engines == (engine,) * K
    assert not _warnings(logged)
    np.testing.assert_array_equal(res.iters, loo_ref.iters)
    np.testing.assert_allclose(res.ll, loo_ref.ll, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("single_read, patched, structure, engine", [
    (False, "max_zloo_members", "loo-structured", "zloo_chunk"),
    (False, None, "loo-structured", "zloo_chunk"),
    (True, "max_sites_members", "gathered", "sites_chunk"),
    (True, None, "gathered", "sites_chunk"),
])
def test_reference_z_above_the_bound(data, jax_plain, monkeypatch, logged,
                                     single_read, patched, structure, engine):
    """With the staging bound patched to 8 members the z-score EMs run the
    same chunk wrappers (populations of 14, 10 and 6), warn of nothing and
    change no iteration count."""
    from wgsassign_tpu.models.zscore import reference_z_scores as jax_z

    beagle, popmap, ad = data
    rt_jax = jax_plain[0]
    want = jax_z(beagle, ad, popmap, single_read_threshold=single_read,
                 runtime=rt_jax)
    if patched:
        mod = zloo_mod if patched == "max_zloo_members" else sites_mod
        monkeypatch.setattr(mod, patched, lambda: 8)
        assert zloo_mod.zloo_chunk_geometry(14, 4)[1] == (
            0 if mod is zloo_mod else 8 * 14 * 32)
        assert (sites_mod.sites_chunk_geometry(13)[1] == 0) == (
            mod is sites_mod)
    rows = []

    def zloo_spy(g0p, *rest):
        rows.append(g0p.shape[0])
        return zloo_mod.zloo_chunk_twin(g0p, *rest)

    def sites_spy(g0p, *rest):
        rows.append(g0p.shape[1])
        return sites_mod.sites_chunk(g0p, *rest)

    cohort = to_device(beagle, make_runtime("cpu"))
    got = tz.reference_z_scores(beagle, ad, popmap,
                                single_read_threshold=single_read,
                                cohort=cohort, zloo_op=zloo_spy,
                                sites_op=sites_spy)
    assert got.structure == structure
    assert got.engine == engine and not _warnings(logged)
    # member rows the wrappers saw: whole populations, or the widest LOO panel
    assert set(rows) == ({13} if single_read else {14, 10, 6})
    np.testing.assert_array_equal(got.loci, want.loci)
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-4)
    monkeypatch.undo()
    base = tz.reference_z_scores(beagle, ad, popmap,
                                 single_read_threshold=single_read,
                                 cohort=cohort)
    np.testing.assert_array_equal(got.em_iters, base.em_iters)


def test_no_pallas_z_scores_run_the_plain_ops(data):
    beagle, popmap, ad = data
    cohort = to_device(beagle, make_runtime("cpu", use_kernels=False))
    base = to_device(beagle, make_runtime("cpu"))
    for single_read in (False, True):
        got = tz.reference_z_scores(beagle, ad, popmap, cohort=cohort,
                                    single_read_threshold=single_read)
        want = tz.reference_z_scores(beagle, ad, popmap, cohort=base,
                                     single_read_threshold=single_read)
        assert got.engine == "plain" and want.engine != "plain"
        np.testing.assert_array_equal(got.em_iters, want.em_iters)
        np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-4)


@pytest.mark.parametrize("geometry, args, bound, warps", [
    (loo_mod.loo_chunk_geometry, (), loo_mod.max_loo_members(),
     loo_mod.LOO_MAX_WARPS),
    (zloo_mod.zloo_chunk_geometry, (4,), zloo_mod.max_zloo_members(), 1),
    (sites_mod.sites_chunk_geometry, (), sites_mod.max_sites_members(),
     sites_mod.SITES_WARPS[0]),
])
def test_wrappers_take_any_population_size(geometry, args, bound, warps):
    """The launch geometry never raises: at the bound the member tile is
    staged in shared memory, one member above it the block takes none."""
    assert bound in (907, 908)
    assert geometry(bound, *args)[1] > 0
    assert geometry(bound + 1, *args) == (warps, 0)
    assert geometry(20 * bound, *args) == (warps, 0)


def test_cli_reports_the_engine(data, tmp_path, monkeypatch, capsys, logged):
    from wgsassign_tpu.io.synth import write_beagle
    from wgsassign_tpu_torch.cli import main

    beagle, popmap, _ = data
    path = str(tmp_path / "c.beagle.gz")
    write_beagle(path, beagle.gl)
    ids = str(tmp_path / "ids.txt")
    with open(ids, "w") as f:
        for i, lab in enumerate(popmap.pop_labels):
            f.write(f"Ind{i}\t{lab}\n")
    monkeypatch.setattr(loo_mod, "max_loo_members", lambda: 10)
    main(["--beagle", path, "--pop_af_IDs", ids, "--get_reference_af",
          "--loo", "-o", str(tmp_path / "o")], device="cpu")
    out = capsys.readouterr().out
    # population a (14 members) lies above the patched staging bound and
    # is reported like the others
    assert "LOO EM engines: a=loo_chunk, b=loo_chunk, c=loo_chunk" in out
    assert "(engine: plain)" not in out
    assert not _warnings(logged)
