"""The port's spans and counters (``wgsassign_tpu_torch/obs/profiling.py``)
on the CPU, on a small synthetic cohort: inert and free with no profiler
recording, nested where the work happens under ``torch.profiler``, counts
that match the results, and outputs bit-identical either way."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import profile

import wgsassign_tpu_torch.obs.profiling as prof
from wgsassign_tpu_torch.io.beagle import BeagleData
from wgsassign_tpu_torch.io.ids import population_map
from wgsassign_tpu_torch.io.synth import synth_cohort
from wgsassign_tpu_torch.models.assign import assignment_loglikelihoods
from wgsassign_tpu_torch.models.common import to_device
from wgsassign_tpu_torch.models.loo import leave_one_out
from wgsassign_tpu_torch.models.reference_af import estimate_reference_af
from wgsassign_tpu_torch.ops.fused_em import FLAG_LAG, _drive_chunks
from wgsassign_tpu_torch.parallel.runtime import make_runtime

torch.set_num_threads(1)

M, N, K = 500, 24, 3


@pytest.fixture(scope="module")
def cohort():
    gl, labels, _ = synth_cohort(M, N, n_pops=K, seed=3)
    beagle = BeagleData(gl, [f"Ind{i}" for i in range(N)],
                        [f"s{j}" for j in range(M)])
    popmap = population_map(beagle.sample_names, list(labels))
    return beagle, popmap, to_device(beagle, make_runtime("cpu"))


def _analysis(cohort):
    """Reference AF, LOO and an assignment pass, as host arrays."""
    beagle, popmap, dev = cohort
    res = estimate_reference_af(beagle, popmap, cohort=dev)
    loo = leave_one_out(beagle, res.af, popmap, cohort=dev,
                        af_t_dev=res.af_t_dev)
    ll = assignment_loglikelihoods(beagle, res.af, cohort=dev)
    return {"af": res.af, "ref_iters": res.iters, "loo_ll": loo.ll,
            "loo_iters": loo.iters, "assign_ll": ll}


def _delta(before):
    after = prof.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_spans_are_inert_without_a_profiler(cohort, monkeypatch):
    """(a) No profiler records: no span enters ``record_function`` or
    synchronizes, every span is one shared object, nothing is counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(prof, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert prof.span("wgsa.a") is prof.span("wgsa.b")
    before, totals = prof.counters(), prof.span_totals()
    _analysis(cohort)
    with prof.RunTimer().phase("loo"):
        pass
    assert prof.counters() == before
    assert prof.span_totals() == totals


def _events(tmp_path, cohort):
    with profile() as p:
        _analysis(cohort)
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("wgsa.")]


def _inside(child, parents):
    return any(p["ts"] <= child["ts"]
               and child["ts"] + child["dur"] <= p["ts"] + p["dur"]
               for p in parents)


def test_trace_holds_the_spans_nested(cohort, tmp_path):
    """(b) The exported trace holds the spans, each inside its parent."""
    events = _events(tmp_path, cohort)
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    for name in ("wgsa.refaf.em", "wgsa.refaf.clamp", "wgsa.refaf.fetch",
                 "wgsa.loo.population", "wgsa.loo.gather", "wgsa.loo.em",
                 "wgsa.loo.bank", "wgsa.loglik.selected", "wgsa.em.chunk",
                 "wgsa.em.steps", "wgsa.em.sync", "wgsa.assign.af_upload",
                 "wgsa.loglik.pass"):
        assert name in by, name
    assert len(by["wgsa.loo.population"]) == K
    for child, parent in (("wgsa.loo.gather", "wgsa.loo.population"),
                          ("wgsa.loo.em", "wgsa.loo.population"),
                          ("wgsa.loo.bank", "wgsa.loo.population"),
                          ("wgsa.loglik.selected", "wgsa.loo.population"),
                          ("wgsa.em.sync", ("wgsa.em.chunk",
                                            "wgsa.em.steps")),
                          ("wgsa.em.replay", "wgsa.em.chunk")):
        parents = sum((by.get(p, []) for p in (
            (parent,) if isinstance(parent, str) else parent)), [])
        for e in by.get(child, []):
            assert _inside(e, parents), (child, parent)
    # the reference AF's EM runs chunks, the LOO EMs one iteration a launch
    for e in by["wgsa.em.chunk"]:
        assert _inside(e, by["wgsa.refaf.em"])
    for e in by["wgsa.em.steps"]:
        assert _inside(e, by["wgsa.loo.em"])
    # siblings: the gathers are not inside the LOO EM
    for e in by["wgsa.loo.gather"]:
        assert not _inside(e, by["wgsa.loo.em"])


def test_span_totals_time_each_recorded_span(cohort):
    """Each recorded span adds one call and its host seconds to its name's
    totals, an enclosing span at least its children's; no CUDA stream on
    the CPU, so no device seconds."""
    before = prof.span_totals()
    with profile():
        _analysis(cohort)
    after = prof.span_totals()

    def added(name, key):
        return after[name][key] - before.get(name, {key: 0})[key]

    assert added("wgsa.loo.population", "calls") == K
    assert added("wgsa.refaf.fetch", "calls") == 1
    assert added("wgsa.loglik.selected", "calls") == K
    inner = sum(added(f"wgsa.loo.{n}", "host_s")
                for n in ("gather", "em", "bank")) + added(
                    "wgsa.loglik.selected", "host_s")
    assert 0 < inner <= added("wgsa.loo.population", "host_s")
    if not torch.cuda.is_initialized():
        assert all(t["device_s"] is None for t in after.values())


def test_useful_iterations_are_the_results(cohort):
    """(c) ``loo_chunk.useful_iters`` is the sum of the LOO convergence
    iterations, ``em_chunk``'s the reference AF's; one host sync an
    ``em_chunk`` chunk, one a LOO EM (its iterations, fetched once), one
    for the AF fetch, one a likelihood call."""
    before = prof.counters()
    with profile():
        out = _analysis(cohort)
    got = _delta(before)
    assert got["loo_chunk.useful_iters"] == int(out["loo_iters"].sum())
    assert got["em_chunk.useful_iters"] == int(out["ref_iters"].sum())
    for name in ("em_chunk", "loo_chunk"):
        assert got[f"{name}.launched_iters"] >= got[f"{name}.useful_iters"]
    assert got["host_syncs"] == got["em_chunk.launches"] + K + 1 + K + 1


def test_a_problem_converging_mid_chunk_is_replayed():
    """(d) Problem 0 converges after 3 of 8 updates, problem 1 after all
    8: the chunk is launched once and replayed once."""
    sq = torch.tensor([[1.0, 1.0]] * 2 + [[0.0, 1.0]] * 5 + [[0.0, 0.0]])
    limits = []

    def run_chunk(ft, limits_vec, T):
        limits.append(limits_vec.tolist())
        return ft + 1, sq[:T]

    before = prof.counters()
    with profile():
        _, iters, active = _drive_chunks(
            run_chunk, None, torch.zeros(2), 2, 8, 1e-4, 1, 8, None,
            name="test_chunk")
    got = _delta(before)
    assert iters.tolist() == [3, 8] and not active.any()
    assert limits == [[8, 8], [3, 8]]
    assert got == {"test_chunk.launches": 1, "test_chunk.replays": 1,
                   "test_chunk.launched_iters": 27,
                   "test_chunk.useful_iters": 11, "host_syncs": 1}
    assert got["test_chunk.launched_iters"] > got["test_chunk.useful_iters"]


def test_a_real_cohort_replays(cohort):
    """(d) On the cohort the reference AF's ``em_chunk`` replays a chunk, as
    it always did, and the LOO EMs replay nothing: each problem's launched
    iterations are its useful ones, and each population's EM launches its
    longest problem's iterations and at most ``FLAG_LAG`` more, in which no
    problem runs."""
    before = prof.counters()
    with profile():
        out = _analysis(cohort)
    got = _delta(before)
    assert {k: v for k, v in got.items() if k.startswith("em_chunk.")} == {
        "em_chunk.launches": 2, "em_chunk.replays": 1,
        "em_chunk.launched_iters": 100, "em_chunk.useful_iters": 52}
    assert got.get("loo_chunk.replays", 0) == 0
    assert got["loo_chunk.launched_iters"] == got["loo_chunk.useful_iters"]
    _, popmap, _ = cohort
    longest = sum(int(out["loo_iters"][popmap.members_of(pop)].max())
                  for pop in popmap.pops)
    tails = got["loo_chunk.tail_launches"]
    assert 0 < tails <= K * FLAG_LAG
    assert got["loo_chunk.launches"] == longest + tails


def test_outputs_are_bit_identical_with_the_profiler(cohort):
    """(e) The profiler on or off changes no output bit."""
    off = _analysis(cohort)
    with profile():
        on = _analysis(cohort)
    for name, want in off.items():
        np.testing.assert_array_equal(on[name], want, err_msg=name)
        assert on[name].dtype == want.dtype


def test_the_gate_flips_inside_the_profiler():
    """(f) The gate is the profiler's own state, so a torch upgrade that
    moves it fails here."""
    assert not prof._recording()
    assert prof.span("wgsa.x") is prof._OFF
    with profile():
        assert prof._recording()
        assert isinstance(prof.span("wgsa.x"), prof._Recorded)
    assert not prof._recording()


def test_run_timer_phases_are_spans_and_report_counts(tmp_path, capsys):
    timer = prof.RunTimer()
    with profile() as p:
        with timer.phase("loo"):
            torch.ones(3).sum()
    path = tmp_path / "t.json"
    p.export_chrome_trace(str(path))
    names = {e.get("name") for e in
             json.loads(path.read_text())["traceEvents"]}
    assert "wgsa.cli.loo" in names
    timer.report({"host_syncs": 4, "em_chunk.launches": 2})
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "-- timing summary --"
    assert out[3] == "-- counters --"
    assert out[4].split() == ["em_chunk.launches", "2"]
    assert out[5].split() == ["host_syncs", "4"]


def test_maybe_profile_hands_back_the_runs_counts(tmp_path):
    with prof.maybe_profile(str(tmp_path), torch.device("cpu")) as counts:
        prof.count("test_maybe.n", 3)
    prof.count("test_maybe.n", 5)  # no profiler: not counted
    assert counts == {"test_maybe.n": 3}
    with prof.maybe_profile(None, torch.device("cpu")) as counts:
        prof.count("test_maybe.n", 2)
    assert counts == {}


@pytest.fixture(scope="module")
def z_cohort():
    """600 sites x 24 individuals in populations of 5, 9 and 10 (uneven, so
    the gathered panels pad the member axis), with their read counts."""
    gl, _, ad = synth_cohort(600, 24, n_pops=3, seed=5)
    labels = np.repeat(["p0", "p1", "p2"], [5, 9, 10])
    beagle = BeagleData(gl, [f"Ind{i}" for i in range(24)],
                        [f"s{j}" for j in range(600)])
    popmap = population_map(beagle.sample_names, list(labels))
    return beagle, popmap, ad, to_device(beagle, make_runtime("cpu"))


def _z_recorded(z_cohort, monkeypatch, single_read):
    """Reference z-scores of all 24 in AF groups of at most 5, under the
    profiler: the result, the counters and span calls it added."""
    import wgsassign_tpu_torch.models.zscore as zmod

    beagle, popmap, ad, dev = z_cohort
    monkeypatch.setattr(zmod, "AF_GROUP_MAX_INDS", 5)
    counts, spans = prof.counters(), prof.span_totals()
    with profile():
        res = zmod.reference_z_scores(beagle, ad, popmap, cohort=dev,
                                      single_read_threshold=single_read,
                                      block_bytes=1)
    calls = {name: t["calls"] - spans.get(name, {"calls": 0})["calls"]
             for name, t in prof.span_totals().items()}
    return res, _delta(counts), calls


def test_gathered_panels_are_a_span_and_counted(z_cohort, monkeypatch):
    """The gathered EM's member-panel gathers are one ``wgsa.zscore.gather``
    span an AF group (groups of 5, 5, 5, 5, 4); ``zscore.gather_useful``
    counts each problem's real members (its population less itself) times
    its kept sites, ``zscore.gather_launched`` every slot of the groups'
    ``[B, p_pad, s_pad]`` panels: ``p_pad`` the largest population less
    one, ``s_pad`` the largest kept count rounded up to a power of two."""
    _, popmap, _, _ = z_cohort
    res, got, calls = _z_recorded(z_cohort, monkeypatch, True)
    assert res.structure == "gathered" and res.engine == "sites_chunk"
    assert calls["wgsa.zscore.gather"] == calls["wgsa.zscore.em"] == 5
    others = np.asarray([popmap.members_of(popmap.pop_labels[i]).size - 1
                         for i in range(24)])
    s_pad = 1 << (int(res.loci.max()) - 1).bit_length()
    assert got["zscore.gather_useful"] == int((others * res.loci).sum())
    assert got["zscore.gather_launched"] == 24 * 9 * s_pad
    assert got["zscore.gather_useful"] < got["zscore.gather_launched"]


def test_loo_structured_z_scores_gather_no_panels(z_cohort, monkeypatch):
    """The loo-structured EM gathers no ``[B, P, S]`` panels: neither the
    span nor the counters are recorded."""
    res, got, calls = _z_recorded(z_cohort, monkeypatch, False)
    assert res.structure == "loo-structured"
    assert calls["wgsa.zscore.em"] == 5
    assert calls.get("wgsa.zscore.gather", 0) == 0
    assert not {"zscore.gather_useful", "zscore.gather_launched"} & set(got)
