"""The port's spans as the benchmark reads them (``spantrace.py`` and the
span readers under ``metrics/``), on synthetic trace events and on the
CPU."""

import sys
from collections import defaultdict

import pytest
import torch
from torch.profiler import profile

from portbench import devtrace, harness, spantrace

SPAN_READERS = ("loo.af_fetch_s", "loo.loglik_s", "loo.gather_s")
READERS = SPAN_READERS + ("loo.loo_chunk_useful_pct",)


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _traced(events):
    """A window of two analyses (100..300 us) around ``events``."""
    return spantrace.SpanTrace.from_events([
        _event(devtrace.ANALYSIS, "user_annotation", 100, 100),
        _event(devtrace.ANALYSIS, "user_annotation", 200, 100), *events])


def _launched(name, cat, ts, dur, corr, at):
    """A device event and the runtime call at ``at`` that launched it."""
    dev = dict(_event(name, cat, ts, dur), args={"correlation": corr})
    call = dict(_event("cudaLaunchKernel", "cuda_runtime", at, 2),
                args={"correlation": corr})
    return [dev, call]


def test_trace_keeps_the_ports_spans():
    events = [
        _event("wgsa.loo.em", "user_annotation", 120, 30),
        _event("wgsa.loo.em", "gpu_user_annotation", 125, 30),  # device row
        _event("other.span", "user_annotation", 130, 10),
        _event("wgsa.refaf.fetch", "user_annotation", 20, 10),  # before
        *_launched("loo_chunk_kernel", "kernel", 150, 20, 7, 140),
    ]
    t = _traced(events)
    assert t.annotations == [("wgsa.loo.em", 120.0, 150.0)]
    assert t.correlations == [7]
    assert t.launches == {7: 140.0}
    # everything the plain reduction keeps, kept the same
    plain = devtrace.DeviceTrace.from_events([
        _event(devtrace.ANALYSIS, "user_annotation", 100, 100),
        _event(devtrace.ANALYSIS, "user_annotation", 200, 100), *events])
    assert (t.start, t.end, t.device, t.host) == (
        plain.start, plain.end, plain.device, plain.host)


def test_span_seconds_counts_nested_spans_once():
    t = _traced([
        _event("wgsa.loo.population", "user_annotation", 110, 50),
        _event("wgsa.loo.em", "user_annotation", 120, 20),
        _event("wgsa.loo.gather", "user_annotation", 112, 5),
        _event("wgsa.loo.population", "user_annotation", 200, 20),
        _event("wgsa.refaf.fetch", "user_annotation", 290, 30),  # clipped
    ])
    assert t.span_seconds("wgsa.loo.") == pytest.approx(70e-6)
    assert t.span_seconds("wgsa.loo.em") == pytest.approx(20e-6)
    assert t.span_seconds("wgsa.") == pytest.approx(80e-6)
    assert t.span_seconds("wgsa.assign") == 0.0


def test_launched_seconds_by_correlation():
    t = _traced([
        _event("wgsa.loglik.selected", "user_annotation", 110, 20),
        _event("wgsa.loo.gather", "user_annotation", 140, 10),
        # launched in the likelihood span, run after it ends
        *_launched("elementwise_kernel", "kernel", 150, 40, 1, 115),
        *_launched("Memcpy DtoH", "gpu_memcpy", 195, 5, 2, 125),
        # launched in the gather span
        *_launched("index_elementwise_kernel", "kernel", 200, 10, 3, 145),
        # launched outside every span
        *_launched("memset", "gpu_memset", 215, 5, 4, 160),
        # no launch event
        dict(_event("orphan_kernel", "kernel", 230, 5),
             args={"correlation": 9}),
    ])
    assert t.launched_seconds("wgsa.loglik.") == pytest.approx(45e-6)
    assert t.launched_seconds("wgsa.loo.gather") == pytest.approx(10e-6)
    assert t.launched_seconds("wgsa.") == pytest.approx(55e-6)
    assert t.launched_seconds("wgsa.assign") == 0.0


def test_idle_gaps_take_the_innermost_port_span():
    events = [
        _event("k1", "kernel", 100, 10),
        # gap 110..160 inside refaf.fetch inside refaf: the inner one
        _event("wgsa.refaf", "user_annotation", 105, 60),
        _event("wgsa.refaf.fetch", "user_annotation", 108, 50),
        _event("k2", "kernel", 160, 10),
        # gap 170..200: a torch op covers it, and keeps its label
        _event("wgsa.loo.population", "user_annotation", 165, 40),
        _event("aten::copy_", "cpu_op", 168, 30),
        _event("k3", "kernel", 200, 10),
        # gap 210..240: a span covers less than half; the analysis span
        # covers all of it, and is never a label
        _event("wgsa.loo.bank", "user_annotation", 230, 12),
        _event("k4", "kernel", 240, 60),
    ]
    got = _traced(events).breakdown()
    gaps = [(label, round(s * 1e6)) for label, s in got["idle_gaps"]]
    assert gaps == [("wgsa.refaf.fetch", 50), ("aten::copy_", 30),
                    (devtrace.OUTSIDE_OPS, 30)]
    plain = devtrace.DeviceTrace.from_events([
        _event(devtrace.ANALYSIS, "user_annotation", 100, 100),
        _event(devtrace.ANALYSIS, "user_annotation", 200, 100),
        *events]).breakdown()
    assert got["device_ops"] == plain["device_ops"]
    assert [s for _, s in got["idle_gaps"]] == [
        s for _, s in plain["idle_gaps"]]
    assert plain["idle_gaps"][0][0] == devtrace.OUTSIDE_OPS


def test_new_readers_read_nothing_untraced():
    run = harness.Run(analyses=3, spans={}, work={}, trace=None)
    for name in READERS:
        assert harness.read_metric(name, run) is None, name


@pytest.fixture
def no_port_records(monkeypatch):
    """The port with nothing recorded yet."""
    import wgsassign_tpu_torch.obs.profiling as prof

    monkeypatch.setattr(prof, "_spans", defaultdict(list))
    monkeypatch.setattr(prof, "_counts", defaultdict(int))
    return prof


def test_new_readers_on_a_port_that_recorded_nothing(no_port_records):
    run = harness.Run(analyses=2, spans={}, work={}, trace=_traced([]))
    for name in READERS:
        assert harness.read_metric(name, run) is None, name


def test_new_readers_on_a_port_without_spans(monkeypatch):
    """A port that times no spans and counts nothing (the parent of this
    change) leaves the readers with nothing to read, and none raises."""
    monkeypatch.setitem(sys.modules, "wgsassign_tpu_torch.obs.profiling",
                        None)
    run = harness.Run(analyses=2, spans={}, work={}, trace=_traced([]))
    for name in READERS:
        assert harness.read_metric(name, run) is None, name


def test_readers_read_the_ports_spans_and_counters(no_port_records):
    prof = no_port_records
    with profile():
        for _ in range(2):
            with prof.span("wgsa.refaf.fetch"):
                torch.ones(64).sum()
        prof.count("loo_chunk.launched_iters", 40)
        prof.count("loo_chunk.useful_iters", 30)
    run = harness.Run(analyses=2, spans={}, work={}, trace=_traced([]))
    host_s = prof.span_totals()["wgsa.refaf.fetch"]["host_s"]
    assert harness.read_metric("loo.af_fetch_s", run) == pytest.approx(
        host_s / 2)
    assert harness.read_metric("loo.loo_chunk_useful_pct", run) == 75.0
    assert harness.read_metric("loo.gather_s", run) is None  # no such span
    if not torch.cuda.is_initialized():  # no CUDA stream: no device seconds
        assert spantrace.port_span_seconds("wgsa.refaf.fetch",
                                           "device_s") is None
    assert spantrace.port_span_seconds("wgsa.refaf.") == pytest.approx(
        host_s)


def test_a_traced_window_reduced_with_spans(no_port_records):
    """``devtrace.profiled``, as the harness calls it, hands back a
    :class:`SpanTrace` inside ``reduced_with_spans`` and a plain
    ``DeviceTrace`` after it."""
    from torch.profiler import record_function

    prof = no_port_records
    plain = devtrace.DeviceTrace
    with spantrace.reduced_with_spans() as kept:
        sink = []
        with devtrace.profiled(True, False, sink):
            with record_function(devtrace.ANALYSIS):
                with prof.span("wgsa.refaf.fetch"):
                    torch.ones(8).sum()
    assert devtrace.DeviceTrace is plain
    assert sink == kept and isinstance(kept[0], spantrace.SpanTrace)
    assert [n for n, _, _ in kept[0].annotations] == ["wgsa.refaf.fetch"]
    assert kept[0].span_seconds("wgsa.refaf.") > 0
    sink = []
    with devtrace.profiled(True, False, sink):
        with record_function(devtrace.ANALYSIS):
            torch.ones(8).sum()
    assert type(sink[0]) is plain


def test_a_tiny_traced_cell_reads_the_new_metrics(no_port_records):
    """A traced ``loo`` run on the CPU at a tiny size: the port's span and
    counter readers report (no CUDA stream here, so not the device-second
    ones), the gaps are reduced with spans, and the cross-checks add up."""
    import time

    from portbench.tests.conftest import tiny

    cell = tiny("loo.wgs180_5m")
    with spantrace.reduced_with_spans() as kept:
        out = harness.run_cell(cell, 2**31 + 11, 0.2, True,
                               torch.device("cpu"), time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["loo.af_fetch_s"]["value"] > 0
    assert 0 < out["metrics"]["loo.loo_chunk_useful_pct"]["value"] <= 100
    checks = spantrace.cross_checks(kept[0])
    fetch = checks["wgsa.refaf.fetch"]
    # the port's host clock runs inside the profiler's range (which also
    # holds the two stream events on a card), up to the clocks' skew
    assert 0 < fetch["port_host_s"] <= fetch["trace_span_s"] + 1e-4
    assert checks["loo_chunk_counted"] >= 1
