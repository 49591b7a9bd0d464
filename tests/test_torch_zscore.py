"""The port's z-score path (``wgsassign_tpu_torch.models.zscore``) against
the JAX package on the CPU, at the model level.

The JAX side runs on a one-device runtime with the Pallas kernels forced on,
so its fused EMs run the TPU kernels in interpret mode; the port runs its
kernels' plain twins.  Tolerances:
- fused EM drivers vs the JAX plain EMs: equal iterations and convergence
  flags, AF atol 2e-6 at kept sites (member sums in another order);
- z sums vs the JAX op: rtol 1e-6, atol 1e-4 (as tests/test_zscore.py holds
  the JAX op to its legacy form);
- host tables: exactly equal (the same numpy code);
- whole-path z, w_obs, w_mu, w_var: rtol 1e-4, atol 1e-4 (float32 sums over
  ~1000 kept sites in another order); loci and EM iterations equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from wgsassign_tpu.io.beagle import BeagleData
from wgsassign_tpu.io.ids import population_map
from wgsassign_tpu.io.synth import synth_cohort
from wgsassign_tpu_torch.models import zscore as tz
from wgsassign_tpu_torch.models.common import to_device
from wgsassign_tpu_torch.ops import zscore_ops
from wgsassign_tpu_torch.ops.fused_em import (
    em_maf_loo_subset_fused,
    em_maf_sites_batch_fused,
)
from wgsassign_tpu_torch.ops.zscore_ops import zscore_sums_batch_compact
from wgsassign_tpu_torch.parallel.runtime import make_runtime

M, N, K = 1024, 20, 2


def _gls(shape, seed):
    raw = np.random.default_rng(seed).dirichlet(np.ones(3), size=shape)
    raw = raw.astype(np.float32)
    return raw[..., 0].copy(), raw[..., 1].copy()


@pytest.mark.parametrize("fast_math", [True, False])
def test_loo_subset_fused_matches_jax_em(fast_math):
    from wgsassign_tpu.ops.emmaf import em_maf_loo_subset

    n_p, m, b = 7, 300, 4
    g0p, g1p = _gls((n_p, m), 11)
    rng = np.random.default_rng(12)
    sw = (rng.random((b, m)) < 0.6).astype(np.float32)
    leave = np.asarray([0, 3, 6, 2], np.int32)
    m_real = sw.sum(axis=1)
    f_ref, it_ref, conv_ref = em_maf_loo_subset(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(leave),
        jnp.asarray(sw), jnp.asarray(m_real), 200, 1e-4)
    f, it, conv = em_maf_loo_subset_fused(
        torch.from_numpy(g0p), torch.from_numpy(g1p), leave,
        torch.from_numpy(sw), m_real, 200, 1e-4, fast_math=fast_math)
    np.testing.assert_array_equal(it, np.asarray(it_ref))
    np.testing.assert_array_equal(conv, np.asarray(conv_ref))
    kept = sw > 0
    np.testing.assert_allclose(f.numpy()[kept], np.asarray(f_ref)[kept],
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("fast_math", [True, False])
def test_sites_batch_fused_matches_jax_em(fast_math):
    from wgsassign_tpu.ops.emmaf import em_maf_sites_batch

    b, p, s = 4, 6, 256
    g0p, g1p = _gls((b, p, s), 13)
    rng = np.random.default_rng(14)
    mask = (rng.random((b, p)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    sw = (np.arange(s)[None, :] < np.asarray([256, 200, 131, 77])[:, None])
    sw = sw.astype(np.float32)
    m_real = sw.sum(axis=1)
    f_ref, it_ref, conv_ref = em_maf_sites_batch(
        jnp.asarray(g0p), jnp.asarray(g1p), jnp.asarray(mask),
        jnp.asarray(sw), jnp.asarray(m_real), 200, 1e-4)
    f, it, conv = em_maf_sites_batch_fused(
        torch.from_numpy(g0p), torch.from_numpy(g1p), mask, sw, m_real,
        200, 1e-4, fast_math=fast_math)
    np.testing.assert_array_equal(it, np.asarray(it_ref))
    np.testing.assert_array_equal(conv, np.asarray(conv_ref))
    kept = sw > 0
    np.testing.assert_allclose(f.numpy()[kept], np.asarray(f_ref)[kept],
                               rtol=0, atol=2e-6)


def test_plain_ems_match_jax_em():
    """The port's plain EMs, the references of the fused drivers."""
    from wgsassign_tpu.ops.emmaf import em_maf_loo_subset as jax_loo_subset
    from wgsassign_tpu.ops.emmaf import em_maf_sites_batch as jax_sites
    from wgsassign_tpu_torch.ops.emmaf import (
        em_maf_loo_subset,
        em_maf_sites_batch,
    )

    g0p, g1p = _gls((5, 200), 15)
    sw = (np.random.default_rng(16).random((3, 200)) < 0.5).astype(np.float32)
    leave = np.asarray([4, 0, 1], np.int32)
    args = (g0p, g1p, leave, sw, sw.sum(axis=1))
    f_r, it_r, _ = jax_loo_subset(*map(jnp.asarray, args), 200, 1e-4)
    f, it, _ = em_maf_loo_subset(*map(torch.from_numpy, args), 200, 1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_r))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=0, atol=2e-6)

    g0b, g1b = _gls((3, 5, 200), 17)
    mask = np.ones((3, 5), np.float32)
    mask[1, 4] = 0.0
    args = (g0b, g1b, mask, sw, sw.sum(axis=1))
    f_r, it_r, _ = jax_sites(*map(jnp.asarray, args), 200, 1e-4)
    f, it, _ = em_maf_sites_batch(*map(torch.from_numpy, args), 200, 1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_r))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=0, atol=2e-6)


def test_zsums_match_jax_op():
    """The random tables of tests/test_zscore.py::test_compact_zsums_match_legacy."""
    from wgsassign_tpu.ops.zscore_ops import (
        zscore_sums_batch_compact as jax_zsums,
    )

    rng = np.random.default_rng(97)
    b, s, c, r = 3, 64, 6, 12
    gl = rng.dirichlet(np.ones(3), (b, s)).astype(np.float32)
    g0k, g1k = gl[:, :, 0].copy(), gl[:, :, 1].copy()
    a = rng.uniform(0.05, 0.95, (b, s)).astype(np.float32)
    weight = (rng.random((b, s)) < 0.8).astype(np.float32)
    depth = rng.integers(1, c, (b, s)).astype(np.int32)
    rows_by_depth = rng.integers(0, r, (b, c, c)).astype(np.int32)
    like_tab = rng.dirichlet(np.ones(3), (b, r)).astype(np.float32)
    fact_tab = rng.uniform(0.01, 1.0, (b, r, 3)).astype(np.float32)
    args = (g0k, g1k, a, weight, depth, rows_by_depth, like_tab, fact_tab)
    want = jax_zsums(*map(jnp.asarray, args))
    got = zscore_sums_batch_compact(*map(torch.from_numpy, args))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-4)


def _kept_slot_operands(seed, m=300, n=9, c=6, r=14, col0=3):
    """The operands of ``kept_slot_sums`` for four individuals with
    different kept counts (one with none) in 96 slots: kept sites
    ascending, padded slots at site 0, uint8 depths below ``c``."""
    rng = np.random.default_rng(seed)
    g0, g1 = _gls((m, n), seed)
    depth = rng.integers(0, c, (m, n))
    minor = rng.integers(0, depth + 1)
    counts = np.stack([depth - minor, minor], axis=2).reshape(m, 2 * n)
    s_local = np.asarray([96, 48, 0, 71])
    g, s = s_local.size, int(s_local.max())
    keep = np.zeros((g, s), np.int64)
    for b, k in enumerate(s_local):
        keep[b, :k] = np.sort(rng.choice(m, k, replace=False))
    a = rng.uniform(0.05, 0.95, (g, s)).astype(np.float32)
    rbd = rng.integers(0, r, (g, c, c)).astype(np.int32)
    mean_gl = rng.dirichlet(np.ones(3), (g, r)).astype(np.float32)
    read_probs = rng.uniform(0.01, 1.0, (g, r, 3)).astype(np.float32)
    t = torch.from_numpy
    return (t(g0), t(g1), t(counts.astype(np.uint8)), col0, t(keep), t(a),
            s_local, t(rbd), t(mean_gl), t(read_probs))


def _gathered(g0, g1, counts, col0, keep, a, s_local, *tables):
    """The kept slots gathered into the ``[G, S]`` operands of
    ``zscore_sums_batch_compact``, as the z-score driver gathered them
    before the sums took kept slots."""
    g, s = keep.shape
    cols = torch.arange(col0, col0 + g)[:, None]
    weight = (torch.arange(s)[None, :]
              < torch.from_numpy(s_local)[:, None]).to(torch.float32)
    ad = counts.view(counts.shape[0], -1, 2)[keep, cols].to(torch.int32)
    depth = torch.where(weight > 0, ad[..., 0] + ad[..., 1], 0)
    return (g0[keep, cols], g1[keep, cols], a, weight, depth, *tables)


@pytest.mark.parametrize("block", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kept_slot_sums_twin_matches_jax_op(block, dtype):
    """The CPU path of the z sums (the kernel's twin), in blocks of
    individuals: the sums of ``zscore_sums_batch_compact`` on the gathered
    operands, bit for bit, and the JAX op's to its tolerance; an
    individual with no kept slot sums to 0."""
    from wgsassign_tpu.ops.zscore_ops import (
        zscore_sums_batch_compact as jax_zsums,
    )

    ops = _kept_slot_operands(98)
    got = zscore_ops.kept_slot_sums(*ops, dtype, block=block)
    assert got.shape == (3, 4) and got.dtype == dtype
    gathered = _gathered(*ops)
    want = torch.stack(zscore_sums_batch_compact(*gathered, sum_dtype=dtype))
    assert torch.equal(got, want)
    assert not got[:, 2].any()
    want_jax = jax_zsums(*(jnp.asarray(t.numpy()) for t in gathered))
    for x, y in zip(got, want_jax):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-4)


@pytest.mark.parametrize("block,blocks", [(None, 1), (1, 4), (3, 2)])
def test_kept_slot_sums_counts_its_slots(block, blocks):
    """While a profiler records, the twin's call counts its blocks, the
    whole padded rows it sums as ``zscore.launched_slots`` and the real
    slots as ``zscore.kept_slots``, all three in one place."""
    from torch.profiler import ProfilerActivity, profile

    from wgsassign_tpu_torch.obs.profiling import counters

    ops = _kept_slot_operands(97)
    names = ("zscore.blocks", "zscore.launched_slots", "zscore.kept_slots")
    before = [counters().get(k, 0) for k in names]
    with profile(activities=[ProfilerActivity.CPU]):
        zscore_ops.kept_slot_sums(*ops, torch.float64, block=block)
    got = [counters().get(k, 0) - b for k, b in zip(names, before)]
    assert got == [blocks, 4 * 96, 96 + 48 + 0 + 71]


def _bad_zsums_operands(case):
    ops = list(_kept_slot_operands(99))
    dtype = torch.float64
    if case == "g0_dtype":
        ops[0] = ops[0].double()
    elif case == "counts_dtype":
        ops[2] = ops[2].to(torch.int16)
    elif case == "keep_dtype":
        ops[4] = ops[4].to(torch.int32)
    elif case == "keep_strides":
        ops[4] = ops[4].t().contiguous().t()
    elif case == "keep_slice":
        ops[4] = torch.zeros((4, 97), dtype=torch.int64)[:, :96]
    elif case == "a_noncontiguous":
        ops[5] = ops[5].t().contiguous().t()
    elif case == "rows_shape":
        ops[7] = ops[7][:, :, :-1]
    elif case == "read_probs_shape":
        ops[9] = ops[9][:3]
    elif case == "s_local_range":
        ops[6] = ops[6] + 1
    elif case == "columns":
        ops[3] = 6
    elif case == "sums_dtype":
        dtype = torch.float16
    return ops, dtype


@pytest.mark.parametrize("case,match", [
    ("cpu", "no kernel for device cpu"),
    ("g0_dtype", "g0 has dtype"),
    ("counts_dtype", "counts have dtype"),
    ("keep_dtype", "keep is torch.int32"),
    ("keep_strides", "keep must have adjacent slots"),
    ("keep_slice", "no kernel for device cpu"),  # a column slice is taken
    ("a_noncontiguous", "a must be contiguous"),
    ("rows_shape", "rows_by_depth has shape"),
    ("read_probs_shape", "read_probs has shape"),
    ("s_local_range", "s_local must be"),
    ("columns", "outside the cohort"),
    ("sums_dtype", "sums in"),
])
def test_zsums_wrapper_rejects_bad_operands(case, match):
    """The kernel's wrapper checks every operand before it launches, and
    launches nothing for CPU tensors (``kept_slot_sums`` takes the twin
    there)."""
    ops, dtype = _bad_zsums_operands(case)
    with pytest.raises(ValueError, match=match):
        zscore_ops.zsums(*ops, dtype)


@pytest.mark.parametrize("g,s_max,c,r", [
    (32, 4_325_000, 16, 256), (3, 1000, 4, 12), (1, 0, 40, 3000),
    (2, 5000, 32, 1024)])
def test_zsums_geometry(g, s_max, c, r):
    """Chunks cover every slot in whole blocks of threads; the tables are
    staged while they fit; the split terms stay in registers up to 16
    splits and are formed twice above."""
    chunk, n_chunks, smem, cmax = zscore_ops.zsums_geometry(g, s_max, c, r)
    assert chunk % zscore_ops.ZSUMS_THREADS == 0
    assert chunk >= zscore_ops.ZSUMS_MIN_CHUNK
    assert n_chunks >= 1 and (n_chunks - 1) * chunk < max(s_max, 1)
    assert n_chunks * chunk >= s_max
    assert g * n_chunks <= max(zscore_ops.ZSUMS_BLOCKS, g)
    tables = 4 * (c * c + 6 * r)
    assert smem == (tables if tables <= zscore_ops.ZSUMS_STAGE_BYTES else 0)
    assert cmax == (16 if c <= 16 else 0)


@pytest.fixture(scope="module")
def cohort_data():
    gl, labels, ad = synth_cohort(M, N, n_pops=K, seed=0)
    names = [f"Ind{i}" for i in range(N)]
    beagle = BeagleData(gl, names, [f"s{i}" for i in range(M)])
    popmap = population_map(names, labels)
    return beagle, popmap, ad, labels


def _device_tables(beagle, ad, threshold, single_read, inds=None):
    """The port's combo tables (``build_tables``, the plain twins on the
    CPU) of individuals ``inds`` (a range), with their cohort and depths."""
    from wgsassign_tpu_torch.models.common import upload_allele_depths

    cohort = to_device(beagle, make_runtime("cpu"))
    depths = upload_allele_depths(ad, cohort)
    inds = range(N) if inds is None else inds
    return tz.build_tables(cohort, depths, inds.start, inds.stop, threshold,
                           single_read), depths


def _individual_tables(tables, depths, j, col):
    """One individual's device tables in the JAX package's host form:
    ``(combos, mean_gl, read_probs, keep_sites, site_row, site_depth)`` and
    its ``rows_by_depth`` cut to the kept-site depths' extent."""
    r = int(tables.n_rows[j])
    combos = tables.combos[j, :r].numpy().astype(np.int64)
    keep_sites = np.flatnonzero(tables.mask[j].numpy())
    ad = depths.counts.numpy().astype(np.int64)
    pairs = ad[keep_sites][:, 2 * col: 2 * col + 2]
    row_of = {tuple(c): k for k, c in enumerate(combos)}
    site_row = np.asarray([row_of[tuple(p)] for p in pairs], np.int32)
    site_depth = pairs.sum(axis=1)
    c = int(site_depth.max()) + 1
    return ((combos, tables.mean_gl[j, :r].numpy(),
             tables.read_probs[j, :r].numpy(), keep_sites, site_row,
             site_depth),
            tables.rows_by_depth[j, :c, :c].numpy())


@pytest.mark.parametrize("threshold,single_read", [(0, False), (3, False),
                                                   (0, True)])
def test_host_tables_equal_jax(cohort_data, threshold, single_read):
    """The device tables (built for all individuals at once) equal the JAX
    package's host tables, individual by individual: combos, kept sites,
    rows, mean GLs, read-probability rows and ``rows_by_depth``."""
    from wgsassign_tpu.models import zscore as jz

    beagle, _, ad, _ = cohort_data
    tables, depths = _device_tables(beagle, ad, threshold, single_read)
    for i in (0, 7, 19):
        want = jz.build_combo_tables(beagle.gl[:, i, :],
                                     ad[:, 2 * i: 2 * i + 2], threshold,
                                     single_read)
        got, rbd = _individual_tables(tables, depths, i, i)
        for name, x, y in zip(("combos", "mean_gl", "read_probs",
                               "keep_sites", "site_row", "site_depth"), got,
                              (want.combos, want.mean_gl, want.read_probs,
                               want.keep_sites, want.site_row,
                               want.site_depth)):
            np.testing.assert_array_equal(x, y, err_msg=name)
        assert tables.s_glob[i] == tables.s_local[i] == want.keep_sites.size
        np.testing.assert_array_equal(rbd, jz._split_tables(want))


def _jax_runtime():
    from wgsassign_tpu.parallel.mesh import make_runtime as jax_runtime

    return jax_runtime(jax.devices()[:1], use_pallas=True)


def _jax_em_iters(beagle, popmap, ad, inds, single_read):
    """Each individual's LOO EM iterations in the JAX package's plain
    gathered EM over its kept sites (built from the JAX host tables)."""
    from wgsassign_tpu.models import zscore as jz
    from wgsassign_tpu.ops.emmaf import em_maf_sites_batch

    keeps, mems = [], []
    for i in inds:
        t = jz.build_combo_tables(beagle.gl[:, i, :], ad[:, 2 * i: 2 * i + 2],
                                  0, single_read)
        members = popmap.members_of(popmap.pop_labels[i])
        keeps.append(t.keep_sites)
        mems.append(members[members != i])
    s, p = max(k.size for k in keeps), max(m.size for m in mems)
    g0p = np.ones((len(inds), p, s), np.float32)
    g1p = np.zeros((len(inds), p, s), np.float32)
    mask = np.zeros((len(inds), p), np.float32)
    sw = np.zeros((len(inds), s), np.float32)
    for b, (k, mm) in enumerate(zip(keeps, mems)):
        g0p[b, : mm.size, : k.size] = beagle.gl[k][:, mm, 0].T
        g1p[b, : mm.size, : k.size] = beagle.gl[k][:, mm, 1].T
        mask[b, : mm.size] = 1.0
        sw[b, : k.size] = 1.0
    _, iters, _ = em_maf_sites_batch(
        *map(jnp.asarray, (g0p, g1p, mask, sw, np.maximum(sw.sum(1), 1.0))),
        200, 1e-4)
    return np.asarray(iters)


CASES = {
    # name: (kwargs, expected reference-mode structure)
    "default": (dict(), "loo-structured"),
    "single_read": (dict(single_read_threshold=True), "gathered"),
    "tiny_blocks": (dict(block_bytes=800_000), "loo-structured"),
    "ind_range": (dict(ind_start=3, ind_end=14, single_read_threshold=True),
                  "gathered"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_z_scores_match_jax(cohort_data, case):
    from wgsassign_tpu.models import zscore as jz

    beagle, popmap, ad, _ = cohort_data
    kwargs, structure = CASES[case]
    want = jz.reference_z_scores(beagle, ad, popmap, runtime=_jax_runtime(),
                                 **kwargs)
    got = tz.reference_z_scores(beagle, ad, popmap,
                                runtime=make_runtime("cpu"), **kwargs)
    assert got.structure == structure
    np.testing.assert_array_equal(got.loci, want.loci)
    for field in ("z", "w_obs", "w_mu", "w_var"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    inds = range(kwargs.get("ind_start", 0), kwargs.get("ind_end", N))
    np.testing.assert_array_equal(
        got.em_iters,
        _jax_em_iters(beagle, popmap, ad, inds,
                      kwargs.get("single_read_threshold", False)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_assignment_z_scores_match_jax(cohort_data, case):
    from wgsassign_tpu.models import zscore as jz

    beagle, _, ad, labels = cohort_data
    kwargs, _ = CASES[case]
    af = np.random.default_rng(3).uniform(0.05, 0.95, (M, K)).astype(
        np.float32)
    pops = np.asarray([f"pop{j}" for j in range(K)])
    assigned = labels[::-1]  # another population than the own for some
    want = jz.assignment_z_scores(beagle, ad, assigned, af, pops,
                                  runtime=_jax_runtime(), **kwargs)
    got = tz.assignment_z_scores(beagle, ad, assigned, af, pops,
                                 runtime=make_runtime("cpu"), **kwargs)
    assert got.structure == "assignment"
    np.testing.assert_array_equal(got.loci, want.loci)
    for field in ("z", "w_obs", "w_mu", "w_var"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-4, atol=1e-4, err_msg=field)


def test_assignment_z_scores_with_float64_sums(cohort_data, monkeypatch):
    """``f64_sums`` (the default; ``--f32_sums`` turns it off): the three z
    sums come back in float64, and z agrees with the float32-sum run to
    that rounding."""
    beagle, _, ad, labels = cohort_data
    af = np.random.default_rng(3).uniform(0.05, 0.95, (M, K)).astype(
        np.float32)
    pops = np.asarray([f"pop{j}" for j in range(K)])
    seen = []

    def recorded(*args, **kwargs):
        out = zscore_sums_batch_compact(*args, **kwargs)
        seen.append({t.dtype for t in out})
        return out

    monkeypatch.setattr(zscore_ops, "zscore_sums_batch_compact", recorded)
    cohort = to_device(beagle, make_runtime("cpu"))
    base = tz.assignment_z_scores(beagle, ad, labels, af, pops, cohort=cohort,
                                  f64_sums=False)
    assert seen and all(d == {torch.float32} for d in seen)
    seen.clear()
    got = tz.assignment_z_scores(beagle, ad, labels, af, pops, cohort=cohort)
    assert seen and all(d == {torch.float64} for d in seen)
    np.testing.assert_array_equal(got.loci, base.loci)
    np.testing.assert_allclose(got.z, base.z, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.w_obs, base.w_obs, rtol=1e-5)


def test_assignment_af_dim_validation(cohort_data):
    beagle, _, ad, labels = cohort_data
    pops = np.asarray([f"pop{j}" for j in range(K)])
    cohort = to_device(beagle, make_runtime("cpu"))
    with pytest.raises(ValueError, match="covers 100 sites"):
        tz.assignment_z_scores(beagle, ad, labels,
                               np.full((100, K), 0.5, np.float32), pops,
                               cohort=cohort)
    with pytest.raises(ValueError, match="has 1 populations"):
        tz.assignment_z_scores(beagle, ad, labels,
                               np.full((M, 1), 0.5, np.float32), pops,
                               cohort=cohort)


def test_zscore_modules_never_load_jax():
    """A fresh interpreter, because this pytest process has imported jax:
    neither ``jax`` nor any module of ``wgsassign_tpu`` is loaded."""
    code = (
        "import sys\n"
        "import wgsassign_tpu_torch.models.zscore\n"
        "import wgsassign_tpu_torch.ops.zscore_ops\n"
        "import wgsassign_tpu_torch.ops.zloo_chunk\n"
        "import wgsassign_tpu_torch.ops.sites_chunk\n"
        "import wgsassign_tpu_torch.ops.fused_em\n"
        "import wgsassign_tpu_torch.cli\n"
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


@pytest.mark.parametrize("seed", [0, 1])
def test_first_float32_log_of_a_process_is_exact(seed):
    """A fresh interpreter with several threads: the port's first
    multi-threaded float32 log of the process (``ops.log``) equals the
    second bit for bit (MKL's first parallel call can return one thread's
    chunk ~2e-5 off; ``ops.log`` makes one serial call first)."""
    code = (
        "import numpy as np, torch\n"
        "torch.set_num_threads(8)\n"
        "from wgsassign_tpu_torch.ops import log\n"
        f"rng = np.random.default_rng({seed})\n"
        "x = torch.from_numpy((rng.random((16, 131072)) * 0.9 + 0.05)"
        ".astype(np.float32))\n"
        "x + 1\n"
        "first, second = log(x), log(x)\n"
        "assert torch.equal(first, second), int((first != second).sum())\n"
        "print('LOG_OK')\n"
    )
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LOG_OK" in proc.stdout


def _small_beagle():
    """40 sites x 3 individuals."""
    gl = np.full((40, 3, 2), 0.3, np.float32)
    return BeagleData(gl, ["a", "b", "c"], [f"s{i}" for i in range(40)])


@pytest.mark.parametrize("largest,dtype", [
    (255, torch.uint8), (256, torch.int32), (2**31 - 1, torch.int32)])
def test_device_depths_take_uint8_or_int32(largest, dtype):
    """Allele depths are held in uint8 where every count fits, else in
    int32, and keep their values."""
    from wgsassign_tpu_torch.models.common import upload_allele_depths

    beagle = _small_beagle()
    ad = np.arange(40 * 6, dtype=np.int64).reshape(40, 6) % 7
    ad[5, 4] = largest
    cohort = to_device(beagle, make_runtime("cpu"))
    depths = upload_allele_depths(ad, cohort)
    assert depths.counts.dtype == dtype
    np.testing.assert_array_equal(
        depths.counts[:40].long().numpy(), ad)
    np.testing.assert_array_equal(depths.col_max, ad.reshape(40, 3, 2)
                                  .max(axis=(0, 2)))


@pytest.mark.parametrize("bad", [-1, 2**31])
def test_device_depths_refuse_counts_int32_cannot_hold(bad):
    from wgsassign_tpu_torch.models.common import upload_allele_depths

    beagle = _small_beagle()
    ad = np.ones((40, 6), dtype=np.int64)
    ad[7, 1] = bad
    cohort = to_device(beagle, make_runtime("cpu"))
    with pytest.raises(ValueError, match="negative|int32"):
        upload_allele_depths(ad, cohort)


def test_ztables_twins_under_kernel_false_equal_the_cpu_path():
    """``kernel=False`` (``--no_pallas``) runs the twins, which walk the
    site axis a chunk at a time: the same partials, mask and counts as the
    default call on CPU tensors."""
    from wgsassign_tpu_torch.ops.ztables import combo_bins, site_filter

    m, n, width, col0, b = 9_001, 12, 6, 2, 9
    rng = np.random.default_rng(5)
    ad = torch.from_numpy(rng.integers(0, width, (m, 2 * n))).to(torch.uint8)
    g = rng.dirichlet(np.ones(3), (m, n)).astype(np.float32)
    g0, g1 = torch.from_numpy(g[..., 0].copy()), torch.from_numpy(
        g[..., 1].copy())
    args = (ad, g0, g1, col0, b, m - 3, width)
    part = combo_bins(*args)
    assert part.shape[0] > 1  # several chunks
    assert torch.equal(combo_bins(*args, kernel=False), part)
    sums = part.sum(0)
    assert float(sums[..., 3].sum()) == b * (m - 3)
    keepc = (sums[..., 3] > 20).to(torch.uint8)
    mean = sums[..., :3] / sums[..., 3:].clamp(min=1.0)
    amax = mean.argmax(2)
    meanv = mean.gather(2, amax[..., None])[..., 0].contiguous()
    out = []
    for kernel in (True, False):
        mask = torch.zeros((b, m), dtype=torch.uint8)
        counts = site_filter(*args, keepc, amax.to(torch.uint8), meanv, mask,
                             0.3, kernel=kernel)
        out.append((mask, counts))
    assert 0 < int(out[0][0].sum()) < b * (m - 3)
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert int(out[0][1].sum()) == int(out[0][0].sum())
