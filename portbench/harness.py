"""Run one cell: set-up, the timed window, the comparison with the plain
reference, and the result line.

A cell ``<traffic>.<config>`` of ``BENCHMARK.json`` is made of files found
by name (see the package docstring).  The traffic file names its entry,
``entries/<entry>.py``, whose ``Entry`` class makes the inputs on the
device from the seed, builds the port's objects, runs one analysis through
the port, counts the work it needed, and computes and compares the
reference.  Everything else is here and is the same for every cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from portbench import devtrace
from portbench.roofline import Work

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# analyses whose full outputs (the [M, K] AF panel) are kept for the
# comparison, drawn from the seed over the window
KEEP_FULL = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "wgsassign_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's, compared whole: ``wgsassign_tpu_torch``
    is not ``wgsassign_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def ulps(got, want) -> float:
    """The largest ``|got - want|`` in units of the float32 spacing at
    ``want`` (NaN when ``got`` holds a NaN)."""
    want = np.asarray(want, np.float64)
    gap = np.abs(np.asarray(got, np.float64) - want)
    return float(np.max(gap / np.spacing(np.abs(want).astype(np.float32))))


def load_file(path: Path, name: str):
    """Import one file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` and everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, workload: str, bench: dict = None,
             root: Path = ROOT) -> "Cell":
        bench = read_json(root / "BENCHMARK.json") if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        config = read_json(root / configs[cell["config"]]["file"])
        traffic = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
        limits = read_json(HERE / "limits" / f"{workload}.json")

        def mine(metric):
            return workload in metric.get("workloads", [workload])

        e2e = [m for m in bench["end_to_end"] if mine(m)]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if mine(m) and m["moves"] in reported]
        return cls(workload, int(cell["chips"]), config, traffic, limits,
                   e2e, per_layer)

    def entry_class(self):
        name = self.traffic["entry"]
        return load_file(HERE / "entries" / f"{name}.py",
                         f"portbench_entry_{name}").Entry


@dataclass
class Run:
    """What a per-layer metric's reader reads: the window's analyses, the
    benchmark's spans around calls into the port (seconds, one per
    analysis), the work the analyses needed (``roofline.Work`` by kernel
    or pass, summed over the window), and the device trace (None in an
    untraced run)."""

    analyses: int
    spans: dict
    work: dict
    trace: object = None


def read_metric(name: str, run: Run):
    reader = load_file(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
    return reader.read(run)


def synchronize(device):
    """Wait for the card, so that a span includes its work."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def judge(numbers: list, limits: dict):
    """``(checks, failed)``: each number's worst reading over the analyses
    beside its limit, and how many analyses had a number over its limit.
    A number that no analysis read, or that read NaN, is reported as None
    and fails."""
    worst = {name: -math.inf for name in limits}
    failed = 0
    for nums in numbers:
        bad = False
        for name, value in nums.items():
            if math.isnan(value) or math.isnan(worst[name]):
                worst[name] = math.nan
            else:
                worst[name] = max(worst[name], value)
            bad |= not value <= limits[name]["limit"]
        failed += bad
    checks = {name: {"value": (v if math.isfinite(v) else None),
                     "limit": limits[name]["limit"]}
              for name, v in worst.items()}
    return checks, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """Run the cell once; returns the result line's object (with the
    ``checks`` key last).  ``started`` is the process's start on the
    ``time.perf_counter`` clock."""
    import torch
    from torch.profiler import record_function

    marks = [("start", time.perf_counter())]
    entry = cell.entry_class()(cell.config, cell.traffic, seed, device)
    entry.make_inputs()
    synchronize(device)
    marks.append(("inputs", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    entry.build()
    marks.append(("build", time.perf_counter()))
    spans = defaultdict(list)
    entry.run(spans)  # warm-up: every shape of the window
    synchronize(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - started
    # where set-up went: imports and CUDA start, then each step
    setup_parts = ", ".join(
        f"{name} {t - t_prev:.3f}" for (name, t), (_, t_prev)
        in zip(marks, [("", started)] + marks[:-1]))

    spans.clear()
    records, full = [], []
    work_by = defaultdict(Work)
    pick = random.Random(f"keep-{seed}")
    traces = []
    with devtrace.profiled(trace, device.type == "cuda", traces):
        t0 = time.perf_counter()
        while True:
            with record_function(devtrace.ANALYSIS):
                rec = entry.run(spans)
            t1 = time.perf_counter()
            # reservoir: KEEP_FULL analyses keep their full outputs
            i = len(records)
            records.append(rec)
            if len(full) < KEEP_FULL:
                full.append(i)
            else:
                j = pick.randrange(i + 1)
                if j < KEEP_FULL:
                    entry.thin(records[full[j]])
                    full[j] = i
                else:
                    entry.thin(rec)
            if t1 - t0 >= seconds:
                break
    window_s = t1 - t0
    n = len(records)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for rec in records:
        for name, w in entry.work(rec).items():
            work_by[name] = work_by[name] + w

    entry.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = entry.reference()
    print(f"portbench: {n} analyses in {window_s:.3f} s, set-up "
          f"{setup_s:.3f} s, peak {peak} bytes, reference "
          f"{time.perf_counter() - t_ref:.3f} s; spans (min median max): "
          + ", ".join(f"{k} {min(v):.4f} {sorted(v)[len(v) // 2]:.4f} "
                      f"{max(v):.4f}" for k, v in spans.items())
          + f"; set-up (s): {setup_parts}", file=sys.stderr)
    checks, failed = judge(entry.compare(records, reference), cell.limits)
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    run = Run(n, dict(spans), dict(work_by), traces[0] if traces else None)
    out = {"correct": bool(correct), "attempted": n, "failed": failed}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
    else:
        values = {cell.traffic["metric"]: window_s / n, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["device"] = dev
    if trace and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out
