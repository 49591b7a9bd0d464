"""The port's own spans and counters, as the benchmark reads them.

Two views of the spans that ``wgsassign_tpu_torch/obs/profiling.py``
records while a profiler records (``wgsa.<layer>.<what>``):

- :func:`port_span_seconds`: the port's own totals (``span_totals()``),
  host seconds or the CUDA stream's seconds per span.  The per-layer
  readers read these, since the traced window's :class:`DeviceTrace`
  keeps no spans.  A port without span timing gives None.
- :class:`SpanTrace`: the profiler's trace with the spans kept, each
  device event tied to the runtime call that launched it (the two share
  ``args.correlation``), and idle gaps that no torch op covers labelled by
  the innermost ``wgsa.*`` span over half of each.  It checks the first
  view against the kernels of the trace::

      python3 portbench/spantrace.py --workload loo.wgs180_5m --seed <n> \\
          --seconds <s>

  runs the cell once, traced, with :class:`SpanTrace` reducing the window,
  prints the result line (its ``breakdown`` relabelled), then one JSON
  line of cross-checks: device seconds launched inside each span family
  beside the port's own timing of it, their share of the busy time, and
  the ``loo_chunk`` kernels beside the port's launch and replay counts.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
from dataclasses import dataclass, field
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    # import the checkout's packages, and nothing of this folder by bare name
    sys.path[0] = str(ROOT)

from portbench import devtrace  # noqa: E402

SPAN_PREFIX = "wgsa."
# host events of the CUDA calls that launch kernels, copies and memsets
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# span families whose device seconds the cross-check compares
FAMILIES = ("wgsa.refaf.fetch", "wgsa.loo.gather", "wgsa.loglik.",
            "wgsa.loo.em")


def port_span_seconds(prefix: str, clock: str = "host_s"):
    """Seconds of the port's spans whose name starts with ``prefix``, on
    ``clock`` (``host_s`` or ``device_s``), summed over what the process
    recorded; None where the port times no spans or recorded none."""
    try:
        from wgsassign_tpu_torch.obs.profiling import span_totals
    except ImportError:  # a port without span timing
        return None
    values = [t[clock] for name, t in span_totals().items()
              if name.startswith(prefix) and t[clock] is not None]
    return sum(values) if values else None


def _merged(intervals) -> list:
    """``[ts, te]`` intervals merged where they overlap or touch."""
    merged = []
    for ts, te in sorted(intervals):
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], te)
        else:
            merged.append([ts, te])
    return merged


@dataclass
class SpanTrace(devtrace.DeviceTrace):
    # (name, ts, end) of the port's wgsa.* spans on the host row
    annotations: list = field(default_factory=list)
    # args.correlation of each device event (None where absent)
    correlations: list = field(default_factory=list)
    # correlation -> ts of the host call that launched it
    launches: dict = field(default_factory=dict)

    @classmethod
    def from_events(cls, events) -> "SpanTrace":
        base = super().from_events(events)
        notes, corr, launches = [], [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat")
            if cat in LAUNCH_CATS:  # kept whatever its time
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launches[c] = ts
                continue
            if te <= base.start or ts >= base.end:
                continue
            if cat in devtrace.DEVICE_CATS:  # the order of base.device
                corr.append((e.get("args") or {}).get("correlation"))
            elif (cat == "user_annotation"
                  and e.get("name", "").startswith(SPAN_PREFIX)):
                notes.append((e["name"], ts, te))
        return cls(base.start, base.end, base.device, base.host, notes,
                   corr, launches)

    def _span_union(self, prefix: str) -> list:
        return _merged((max(ts, self.start), min(te, self.end))
                       for name, ts, te in self.annotations
                       if name.startswith(prefix))

    def span_seconds(self, prefix: str) -> float:
        """Host seconds of the window inside a ``wgsa.*`` span whose name
        starts with ``prefix``, nested spans counted once."""
        return 1e-6 * sum(te - ts for ts, te in self._span_union(prefix))

    def launched_seconds(self, prefix: str) -> float:
        """Device seconds (in the window) of the kernels, copies and
        memsets whose launching call starts inside a ``wgsa.*`` span whose
        name starts with ``prefix``."""
        union = self._span_union(prefix)
        starts = [ts for ts, _ in union]
        total = 0.0
        for (_, _, ts, te), c in zip(self.device, self.correlations):
            at = self.launches.get(c)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= union[i][1]:
                total += min(te, self.end) - max(ts, self.start)
        return 1e-6 * total

    def _innermost_span(self, gs: float, ge: float):
        """The shortest ``wgsa.*`` span covering at least half of
        ``[gs, ge]``, or None."""
        best = None
        for name, ts, te in self.annotations:
            if (min(te, ge) - max(ts, gs) >= 0.5 * (ge - gs)
                    and (best is None or te - ts < best[1])):
                best = (name, te - ts)
        return None if best is None else best[0]

    def breakdown(self) -> dict:
        """:meth:`DeviceTrace.breakdown`, with each gap it labels
        ``OUTSIDE_OPS`` labelled by the innermost ``wgsa.*`` span covering
        half of it where there is one."""
        out = super().breakdown()
        gaps, last = [], self.start
        for ts, te in self._busy_intervals():
            if ts > last:
                gaps.append((last, ts))
            last = max(last, te)
        if last < self.end:
            gaps.append((last, self.end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:devtrace.TOP]
        for row, (gs, ge) in zip(out["idle_gaps"], gaps):
            if row[0] == devtrace.OUTSIDE_OPS:
                row[0] = self._innermost_span(gs, ge) or devtrace.OUTSIDE_OPS
        return out


@contextlib.contextmanager
def reduced_with_spans():
    """Inside the block, ``devtrace.profiled`` reduces a traced window to
    a :class:`SpanTrace`; yields the list of the traces it made."""
    kept = []

    class Keep:
        @staticmethod
        def from_events(events):
            kept.append(SpanTrace.from_events(events))
            return kept[-1]

    plain, devtrace.DeviceTrace = devtrace.DeviceTrace, Keep
    try:
        yield kept
    finally:
        devtrace.DeviceTrace = plain


def cross_checks(trace: SpanTrace) -> dict:
    """The port's own span timing and counters beside the trace."""
    from wgsassign_tpu_torch.obs.profiling import counters

    counts = counters()
    out = {"busy_s": trace.busy_s,
           "window_s": trace.window_s}
    for prefix in FAMILIES:
        out[prefix] = {
            "launched_s": trace.launched_seconds(prefix),
            "port_device_s": port_span_seconds(prefix, "device_s"),
            "trace_span_s": trace.span_seconds(prefix),
            "port_host_s": port_span_seconds(prefix, "host_s")}
    out["launched_share_of_busy"] = (
        trace.launched_seconds(SPAN_PREFIX) / trace.busy_s
        if trace.busy_s > 0 else None)  # None: no device events (CPU)
    out["loo_chunk_kernels"] = sum(
        1 for name, cat, _, _ in trace.device
        if cat == "kernel" and "loo_chunk_kernel" in name)
    out["loo_chunk_counted"] = (counts.get("loo_chunk.launches", 0)
                                + counts.get("loo_chunk.replays", 0))
    out["counters"] = counts
    return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench import run

    with reduced_with_spans() as kept:
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    if rc or not kept:
        return rc or 1
    print(json.dumps({"cross_checks": cross_checks(kept[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
