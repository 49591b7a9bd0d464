"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <traffic>.<config> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up makes the cell's inputs on the card from the seed, builds the
port's objects and runs one analysis (the port builds its kernels into
the checkout's ``build/`` in the first run there, and loads them after).  The
window then runs whole analyses back to back until ``--seconds`` have
passed, and ends at the last completion.  After it the plain reference
checks the outputs.  The last line of standard output is one JSON object;
the compared numbers and their limits are also the last lines of standard
error.  ``--trace 1`` profiles the window and reports the per-layer
metrics instead of the end-to-end ones.

Exits non-zero, printing no result, without a CUDA card (or fewer than
the cell asks for), or when JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# import the checkout's packages, and nothing of this folder by bare name
sys.path[0] = str(ROOT)


def _card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or ''."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    imported = time.perf_counter()
    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(f"portbench: start to imports {imported - STARTED:.3f} s, to "
          f"CUDA found {time.perf_counter() - STARTED:.3f} s",
          file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              STARTED)
    result["device"]["card"] = _card_line()
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit "
              f"{check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
