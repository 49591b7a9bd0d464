"""The benchmark's yardstick on the CPU: the data generator, the work
counts, the trace reduction, the judgement of the numbers and the no-JAX
check."""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import cohort, devtrace, harness, reference, roofline


def test_same_seed_same_cohort_any_seed_width():
    def make(seed):
        gen = cohort.make_generator(seed, "cpu")
        af = cohort.population_af(gen, 500, 3, 0.05, "cpu")
        return cohort.genotype_likelihoods(gen, af, np.arange(12) % 3, 2.0,
                                           0.01)

    a, b, c = make(2**33 + 5), make(2**33 + 5), make(-7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    g2 = 1.0 - a[0] - a[1]
    assert bool((a[0] > 0).all()) and bool((g2 > -1e-6).all())


def test_gl_table_matches_binomial_likelihoods():
    t = cohort.gl_table(3, 0.01)
    l0, l1, l2 = 0.99**2 * 0.01, 0.5**3, 0.01**2 * 0.99
    assert t[2, 1, 0] == pytest.approx(l0 / (l0 + l1 + l2), rel=1e-6)
    assert t[2, 1, 1] == pytest.approx(l1 / (l0 + l1 + l2), rel=1e-6)
    assert t[0, 0, 0] == pytest.approx(1 / 3)


def test_population_sizes_scale_the_amre_panel():
    amre = [14, 20, 15, 23, 13]
    assert cohort.proportional_sizes(amre, 85).tolist() == amre
    assert cohort.proportional_sizes(amre, 180).tolist() == [30, 42, 32, 49,
                                                             27]
    assert cohort.proportional_sizes(amre, 80).tolist() == [13, 19, 14, 22,
                                                            12]
    assert cohort.proportional_sizes(amre, 34).tolist() == [6, 8, 6, 9, 5]
    for name in [c["name"] for c in harness.read_json(
            harness.ROOT / "BENCHMARK.json")["configs"]]:
        cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
        sizes = cohort.population_sizes(cfg)
        assert sizes.tolist() == cohort.proportional_sizes(
            amre, cfg["individuals"]).tolist()
    assert cohort.population_index([2, 1, 3]).tolist() == [0, 0, 1, 2, 2, 2]
    with pytest.raises(ValueError):
        cohort.population_sizes({"population_sizes": [2, 2],
                                 "populations": 2, "individuals": 5})


def test_clamp_panel_per_population():
    af = torch.tensor([[0.0, 0.0], [0.5, 0.5], [1.0, 1.0]])
    got = cohort.clamp_panel(af, [1, 4])
    assert got[0].tolist() == pytest.approx([0.25, 0.1])
    assert got[1].tolist() == [0.5, 0.5]
    assert got[2].tolist() == pytest.approx([0.75, 0.9])


def test_work_counts_by_hand():
    # reference AF: 2 populations of 3 and 2 members, 4 and 7 iterations
    w = roofline.reference_af_em(10, [3, 2], [4, 7])
    assert w.ops == 15 * 10 * (3 * 4 + 2 * 7)
    assert w.nbytes == 4 * (2 * 10 * 5 + 2 * 10)
    # LOO of 4 members: 3 weights a site per problem iteration
    w = roofline.loo_em(10, 4, [5, 5, 6, 2])
    assert w.ops == 15 * 10 * 3 * 18 and w.nbytes == 4 * 3 * 4 * 10
    w = roofline.loglik(10, 6, 2, 8)
    assert w.ops == 15 * 10 * 6 * 2
    assert w.nbytes == 4 * (2 * 10 * 6 + 8 * 10 + 10) + 8 * 6 * 2
    assert (w + w).nbytes == 2 * w.nbytes
    big = roofline.Work(67e12, 3.35e12)
    assert big.bound_s() == pytest.approx(1.0)
    assert roofline.Work(1e12, 6.7e12).bound_s() == pytest.approx(2.0)


def test_loo_work_at_the_published_size():
    # wgs180_5m: 36 members, every problem 12 iterations
    w = roofline.loo_em(5_000_000, 36, [12] * 36)
    assert w.ops == 15 * 5e6 * 35 * 12 * 36
    assert w.bound_s() == pytest.approx(w.ops / 67e12)


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _event(devtrace.ANALYSIS, "user_annotation", 100, 100),
        _event(devtrace.ANALYSIS, "user_annotation", 200, 100),
        _event("loo_chunk_kernel<true>", "kernel", 110, 40),
        _event("loo_chunk_kernel<true>", "kernel", 140, 20),  # overlaps
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 210, 10),
        _event("em_chunk_kernel", "kernel", 250, 30),
        _event("aten::argsort", "cpu_op", 220, 25),
        _event("early", "kernel", 10, 20),  # before the window
    ]
    t = devtrace.DeviceTrace.from_events(events)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(90e-6)
    assert t.idle_pct() == pytest.approx(55.0)
    assert t.seconds("kernel", "loo_chunk") == pytest.approx(60e-6)
    assert t.seconds("gpu_memcpy", "HtoD") == pytest.approx(10e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["loo_chunk_kernel<true>",
                                  pytest.approx(60e-6)]
    gaps = dict((round(s * 1e6), label) for label, s in b["idle_gaps"])
    assert gaps[50] == devtrace.OUTSIDE_OPS          # 160..210
    assert gaps[30] == "aten::argsort"               # 220..250
    assert gaps[20] == devtrace.OUTSIDE_OPS          # 280..300
    assert len(b["idle_gaps"]) <= devtrace.TOP


def test_judge_fails_missing_nan_and_over_limit():
    limits = {"a": {"limit": 1.0}, "b": {"limit": 0}}
    checks, failed = harness.judge([{"a": 0.5, "b": 0.0}], limits)
    assert failed == 0 and checks["a"]["value"] == 0.5
    checks, failed = harness.judge([{"a": 0.5}, {"a": 2.0, "b": 1.0}],
                                   limits)
    assert failed == 1 and checks["b"]["value"] == 1.0
    checks, failed = harness.judge([{"a": math.nan, "b": 0}, {"a": 0.1,
                                                              "b": 0}],
                                   limits)
    assert failed == 1 and checks["a"]["value"] is None
    checks, _ = harness.judge([{"a": 0.1}], limits)
    assert checks["b"]["value"] is None


def test_ulps():
    x = np.float64(-3e6)
    step = float(np.spacing(np.float32(3e6)))
    assert harness.ulps(np.float32(x), x) == 0.0
    assert harness.ulps(np.array([x + 2 * step]), np.array([x])) == 2.0
    assert math.isnan(harness.ulps(np.array([np.nan]), np.array([x])))


def test_round_tf32_and_bf16():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10,
                      0.3])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0  # tie to even
    assert r[2] == 1.0 + 2 * 2**-10 and r[3] == x[3]
    assert abs(float(r[4]) - 0.3) <= 2**-11 * 0.3
    assert reference.round_bf16(torch.tensor([1.0 + 2**-9]))[0] == 1.0


def test_forbidden_modules_compare_whole_top_level_names():
    found = harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "wgsassign_tpu", "wgsassign_tpu.ops", "wgsassign_tpu_torch",
         "wgsassign_tpu_torch.ops.loglik", "jaxtyping", "portbench"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                     "wgsassign_tpu", "wgsassign_tpu.ops"]


def test_reference_and_harness_import_no_jax_nor_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference, portbench.harness, "
            "portbench.cohort, portbench.devtrace; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'wgsassign_tpu', "
            "'wgsassign_tpu_torch')]; print(bad); assert not bad"
            % str(harness.ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    text = (harness.HERE / "reference.py").read_text()
    assert "import jax" not in text and "wgsassign_tpu" not in \
        text.replace("wgsassign_tpu_torch", "")
    assert "from wgsassign" not in text and "import wgsassign" not in text
