"""The traced window: ``torch.profiler`` over the analyses, reduced to
device time by kernel, copy time, the busy share and the idle gaps.

Each analysis of the window runs inside ``record_function(ANALYSIS)``; the
window is the profiler's own span from the first analysis's start to the
last one's end, so device and host events are on one clock.  The trace is
exported as Chrome JSON (a temporary file under ``TMPDIR``, removed after
it is read) and only its complete events are read.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

ANALYSIS = "portbench.analysis"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE_OPS = "host_code_outside_torch_ops"
TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool, sink: list):
    """Profile the block when ``enabled``; append its
    :class:`DeviceTrace` to ``sink`` once the block ends."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False,
                 profile_memory=False, with_stack=False) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    sink.append(DeviceTrace.from_events(events))


@dataclass
class DeviceTrace:
    start: float                      # window, microseconds
    end: float
    device: list = field(default_factory=list)   # (name, cat, ts, end)
    host: list = field(default_factory=list)     # (name, ts, end) torch ops

    @classmethod
    def from_events(cls, events) -> "DeviceTrace":
        marks = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name") == ANALYSIS
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError("the trace holds no analysis span")
        start = min(s for s, _ in marks)
        end = max(t for _, t in marks)
        device, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if te <= start or ts >= end:
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                device.append((e["name"], cat, ts, te))
            elif cat == "cpu_op":
                host.append((e["name"], ts, te))
        return cls(start, end, device, host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def _busy_intervals(self) -> list:
        spans = sorted((max(ts, self.start), min(te, self.end))
                       for _, _, ts, te in self.device)
        merged = []
        for ts, te in spans:
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], te)
            else:
                merged.append([ts, te])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a kernel or a copy ran."""
        return sum(te - ts for ts, te in self._busy_intervals()) * 1e-6

    def idle_pct(self):
        """Idle share of the window in %, None where no device event was
        traced at all (a run on the CPU)."""
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def seconds(self, cat: str, contains: str = "") -> float:
        """Summed duration of the window's device events of ``cat`` whose
        name contains ``contains``."""
        return 1e-6 * sum(te - ts for name, c, ts, te in self.device
                          if c == cat and contains in name)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each labelled by the torch op the host spent most of it in
        (``OUTSIDE_OPS`` where torch ops cover less than half of it)."""
        per_op = defaultdict(float)
        for name, _, ts, te in self.device:
            per_op[name] += (min(te, self.end) - max(ts, self.start)) * 1e-6
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, last = [], self.start
        for ts, te in self._busy_intervals():
            if ts > last:
                gaps.append((last, ts))
            last = max(last, te)
        if last < self.end:
            gaps.append((last, self.end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        h_ts = np.array([t for _, t, _ in self.host], dtype=np.float64)
        h_te = np.array([t for _, _, t in self.host], dtype=np.float64)
        labelled = []
        for gs, ge in gaps:
            label = OUTSIDE_OPS
            if h_ts.size:
                over = np.minimum(h_te, ge) - np.maximum(h_ts, gs)
                best = int(np.argmax(over))
                if over[best] >= 0.5 * (ge - gs):
                    label = self.host[best][0]
            labelled.append([label, (ge - gs) * 1e-6])
        return {"device_ops": [[name[:96], s] for name, s in ops],
                "idle_gaps": labelled}
