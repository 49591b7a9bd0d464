"""The benchmark's single-read z-score cell (``zscore_single.wgs180_5m_ad``)
on the CPU at a tiny size: the sound port comes out ``correct`` against
the plain reference (``portbench/zreference.py``) on its gathered path;
the control (the reference with TF32 member sums and float32 z sums in the
port's place) and two faults planted in the port's gathered EM (a chunk
that returns its state unchanged, member weights rounded to TF32 before
they are summed) come out not correct under the cell's limits; each
per-layer reader the cell reports reads nothing from an untraced run, and
the counters' readers read the port's counters from a traced one."""

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import tiny

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**31 + 23
WORKLOAD = "zscore_single.wgs180_5m_ad"


def _cell():
    return tiny(WORKLOAD, sites=3000, sizes=(5, 7, 6), ind_end=18)


def _run(cell, trace=False, seconds=0.2):
    return harness.run_cell(cell, SEED, seconds, trace, CPU,
                            time.perf_counter())


def _entry():
    cell = _cell()
    entry = cell.entry_class()(cell.config, cell.traffic, SEED, CPU)
    entry.make_inputs()
    return cell, entry


def test_port_takes_the_gathered_path_and_equals_the_reference(monkeypatch):
    """Loci and EM iterations equal the reference's, z within the cell's
    limit; the kept fraction sits near 2e^-2, so the port gathers and runs
    ``sites_chunk`` (its twin on the CPU)."""
    import wgsassign_tpu_torch.models.zscore as zmod

    results = []
    orig = zmod.reference_z_scores

    def kept(*a, **k):
        results.append(orig(*a, **k))
        return results[-1]

    monkeypatch.setattr(zmod, "reference_z_scores", kept)
    cell, entry = _entry()
    entry.build()
    rec = entry.run({"zscore": []})
    (res,) = results
    assert res.structure == "gathered" and res.engine == "sites_chunk"
    assert 0.2 < rec["fill"] < 0.35
    nums = entry.compare([rec], entry.reference())[0]
    assert nums["loci_gap"] == 0 and nums["iter_gap"] == 0
    assert nums["z_gap"] < cell.limits["z_gap"]["limit"]
    work = entry.work(rec)
    assert set(work) == {"sites_chunk", "ztables"}
    assert work["sites_chunk"].ops > 0


def test_sound_run_is_correct():
    out = _run(_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"loci_gap", "iter_gap", "z_gap"}


def test_control_is_not_correct():
    cell, entry = _entry()
    ref = entry.reference()
    nums = entry.compare([entry.as_record(entry.control_reference())], ref)
    _, failed = harness.judge(nums, cell.limits)
    assert failed == 1


def _stale_em(monkeypatch):
    import wgsassign_tpu_torch.models.zscore as zmod

    def stale(g0p, g1p, ft, mask, sw, limits, inv_counts, T,
              fast_math=True):
        return ft.clone(), torch.zeros((T, ft.shape[0]))

    orig = zmod.em_maf_sites_batch_fused
    monkeypatch.setattr(zmod, "em_maf_sites_batch_fused",
                        lambda *a, **k: orig(*a, **dict(k, chunk_op=stale)))


def _tf32_member_sums(monkeypatch):
    import wgsassign_tpu_torch.ops.sites_chunk as sc_mod
    from portbench.reference import round_tf32

    orig = sc_mod.em_w
    monkeypatch.setattr(sc_mod, "em_w",
                        lambda *a: round_tf32(orig(*a)))


@pytest.mark.parametrize("plant", [_stale_em, _tf32_member_sums])
def test_planted_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    out = _run(_cell())
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]
    assert np.isfinite([c["value"] for c in out["checks"].values()
                        if c["value"] is not None]).all()


def test_the_single_read_config_draws_the_z_cells_cohort():
    """The cell's configuration states the single-read deployment under its
    own source, and every number of the generative model is the z cell's,
    so one seed draws the same GLs and depths in both cells."""
    single = harness.Cell.load(WORKLOAD).config
    z = harness.Cell.load("zscore.wgs180_5m_ad").config
    assert "--single_read_threshold" in single["source"]
    assert single["source"] != z["source"]
    assert "z_score_loci" in single and "z_score_loci" in single["assumed"]
    numbers = {k: v for k, v in z.items()
               if isinstance(v, (int, float, list))}
    assert numbers and {k: single[k] for k in numbers} == numbers


def _metrics():
    return [m["name"] for m in _cell().per_layer]


# the cell's own readers, then the z cell's, whose spans, counters and
# work keys the gathered path records too
OWN = ["zscore_single.gather_s", "zscore_single.gather_useful_pct",
       "zscore_single.sites_chunk_roofline",
       "zscore_single.sites_chunk_useful_pct"]
SHARED = ["zscore.tables_s", "zscore.em_s", "zscore.sums_s",
          "zscore.tables_roofline", "zscore.sums_useful_pct",
          "zscore.device_idle_pct", "zscore.step_mfu"]


def test_the_cell_reports_its_own_and_the_z_cells_metrics():
    assert sorted(_metrics()) == sorted(OWN + SHARED)


@pytest.mark.parametrize("name", OWN + SHARED)
def test_reader_reads_nothing_from_an_untraced_run(name):
    work = {"sites_chunk": harness.Work(1e9, 1e9),
            "ztables": harness.Work(0.0, 1e9)}
    run = harness.Run(analyses=3, spans={"zscore": [1.0] * 3}, work=work)
    assert harness.read_metric(name, run) is None


def test_traced_run_reads_the_ports_counters():
    """On the CPU the trace has no device event, so the device metrics read
    nothing; the spans' host seconds and the counters' shares read."""
    out = _run(_cell(), trace=True)
    got = out["metrics"]
    assert 0 < got["zscore_single.gather_useful_pct"]["value"] < 100
    assert 0 < got["zscore_single.sites_chunk_useful_pct"]["value"] <= 100
    assert 0 < got["zscore.sums_useful_pct"]["value"] <= 100
    for name in ("zscore.em_s", "zscore.tables_s", "zscore.sums_s"):
        assert got[name]["value"] > 0
    for name in ("zscore.device_idle_pct", "zscore.tables_roofline",
                 "zscore_single.sites_chunk_roofline",
                 "zscore_single.gather_s"):
        assert name not in got
