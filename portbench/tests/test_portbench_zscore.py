"""The z-score cell on the CPU at a tiny size: the sound port comes out
``correct``; the control (the reference with TF32 member sums and float32
z sums in the port's place) and two faults planted in the port (an EM
step that returns its state unchanged, a site filter that keeps one site
too many) come out not correct.  Also: the depth generator draws what
``cohort.py`` draws, and keeps the counts behind each GL."""

import time

import numpy as np
import pytest
import torch

from portbench import cohort, harness, zcohort
from portbench.tests.conftest import tiny

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**31 + 11


def _cell():
    return tiny("zscore.wgs180_5m_ad", sites=3000, sizes=(5, 7, 6),
                ind_end=18)


def _run(cell, seconds=0.2):
    return harness.run_cell(cell, SEED, seconds, False, CPU,
                            time.perf_counter())


def test_depths_behind_the_gls():
    pop = cohort.population_index((4, 3))
    gens = [cohort.make_generator(SEED, CPU) for _ in range(2)]
    afs = [cohort.population_af(g, 500, 2, 0.05, CPU) for g in gens]
    g0, g1 = cohort.genotype_likelihoods(gens[0], afs[0], pop, 2.0, 0.01)
    z0, z1, ad = zcohort.genotype_likelihoods_and_depths(gens[1], afs[1],
                                                         pop, 2.0, 0.01)
    assert torch.equal(g0, z0) and torch.equal(g1, z1)
    table = torch.from_numpy(cohort.gl_table(cohort.MAX_DEPTH, 0.01))
    pairs = ad.view(500, -1, 2).long()
    assert torch.equal(table[pairs[..., 0], pairs[..., 1], 0], z0)
    assert ad.dtype == torch.uint8


def test_sound_run_is_correct():
    out = _run(_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"loci_gap", "iter_gap", "z_gap"}


def test_control_is_not_correct():
    cell = _cell()
    entry = cell.entry_class()(cell.config, cell.traffic, SEED, CPU)
    entry.make_inputs()
    ref = entry.reference()
    nums = entry.compare([entry.as_record(entry.control_reference())], ref)
    _, failed = harness.judge(nums, cell.limits)
    assert failed == 1


def _stale_em(monkeypatch):
    import wgsassign_tpu_torch.models.zscore as zmod

    def stale(g0p, g1p, ft, sw, leave, limits, n_real, T, fast_math=True):
        return ft.clone(), torch.zeros((T, ft.shape[0]))

    orig = zmod.em_maf_loo_subset_fused
    monkeypatch.setattr(zmod, "em_maf_loo_subset_fused",
                        lambda *a, **k: orig(*a, **dict(k, chunk_op=stale)))


def _one_more_site(monkeypatch):
    import wgsassign_tpu_torch.models.zscore as zmod

    orig = zmod.site_filter

    def loose(ad, g0, g1, col0, b, n_sites, width, keepc, amax, meanv,
              mask, tol, **kw):
        out = orig(ad, g0, g1, col0, b, n_sites, width, keepc, amax, meanv,
                   mask, tol, **kw)
        mask[:, 0] = 1
        return out

    monkeypatch.setattr(zmod, "site_filter", loose)


@pytest.mark.parametrize("plant", [_stale_em, _one_more_site])
def test_planted_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    out = _run(_cell())
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]
    assert np.isfinite([c["value"] for c in out["checks"].values()
                        if c["value"] is not None]).all()
