"""Readings of the compared numbers, from which each cell's limits are set.

    python3 portbench/readings.py --workload <cell> --seeds 11 12 ... \\
        [--controls 3] [--out readings.jsonl]

For each seed, at the cell's own size and in one process: the inputs, one
warm-up analysis, one analysis through the port as the cell runs it
(``sound``), one with the port's own float32-sum path (``f32_sums``), and
the plain reference; for the first ``--controls`` seeds also the control,
the reference in a lower precision put in the port's place (``control``:
TF32 member sums in the EMs for ``loo``, bfloat16 likelihood operands for
``assign``).  Each seed prints one JSON line of the numbers each of these
reads.  The lower reading of a number is the largest ``sound`` reading over
the seeds; the upper reading the smallest ``control`` reading.
"""

import argparse
import gc
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.Cell.load(args.workload)
    device = torch.device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for i, seed in enumerate(args.seeds):
        entry = cell.entry_class()(cell.config, cell.traffic, seed, device)
        entry.make_inputs()
        entry.build()
        spans = defaultdict(list)
        entry.run(spans)  # warm-up
        t0 = time.perf_counter()
        sound = entry.run(spans)
        seconds = time.perf_counter() - t0
        entry.f64_sums = False
        f32 = entry.run(spans)
        entry.f64_sums = True
        entry.release()
        gc.collect()
        t0 = time.perf_counter()
        ref = entry.reference()
        ref_s = time.perf_counter() - t0
        sound_n, f32_n = entry.compare([sound, f32], ref)
        line = {"workload": cell.name, "seed": seed, "device": kind,
                "analysis_s": seconds, "reference_s": ref_s,
                "sound": sound_n, "f32_sums": f32_n,
                "work": {k: [w.ops, w.nbytes]
                         for k, w in entry.work(sound).items()}}
        if i < args.controls:
            t0 = time.perf_counter()
            ctl = entry.as_record(entry.control_reference())
            line["control_s"] = time.perf_counter() - t0
            line["control"] = entry.compare([ctl], ref)[0]
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
        del entry, ref, sound, f32
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if harness.forbidden_modules():
        print(f"JAX or the JAX package was loaded: "
              f"{harness.forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
