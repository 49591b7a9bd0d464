"""BENCHMARK.json and the files it names: found by name, and every name,
unit and key within the benchmark contract's limits."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    # the full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    for item in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(item) <= KEYS[section] | extra
        assert NAME.match(item["name"]), item["name"]
        if "unit" in item:
            assert UNIT.match(item["unit"]), item["unit"]
            assert item["better"] in ("lower", "higher")
        texts = [item[k] for k in ("why", "layer") if k in item]
        if section == "configs":
            texts.append(item["source"])
        for text in texts:
            assert 1 <= len(text) <= 200
            assert "\n" not in text and "\t" not in text
    names = [item["name"] for item in BENCH[section]]
    assert len(names) == len(set(names))


def test_metric_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.Cell.load(workload)
    assert cell.chips == 1
    entry = cell.entry_class()
    for method in ("make_inputs", "build", "run", "work", "reference",
                   "control_reference", "compare", "thin", "release"):
        assert callable(getattr(entry, method))
    # every cell reports setup_s, another end-to-end metric and a per-layer
    # metric that moves one of them
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and cell.traffic["metric"] in names
    assert cell.per_layer
    for m in cell.per_layer:
        path = harness.HERE / "metrics" / f"{m['name']}.py"
        assert callable(harness.load_file(path, "m").read)
    for name, limit in cell.limits.items():
        assert limit["limit"] >= 0, name


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = {p.stem for p in (harness.HERE / "configs").glob("*.json")}
    assert files == used
    readers = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["reduced"] == [] and "assumed" in cfg


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                              BENCH["workloads"]]))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 4
