#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Set-up (tables or weights made on the card
from the seed, kernels built into build/ inside the checkout, the cell's
shapes warmed up) is timed as `setup_s`; then the cell's traffic runs
for `--seconds`; then the plain reference judges a seeded sample of what
the window produced. `--trace 0` prints the end-to-end metrics, `--trace
1` the per-layer ones, read from harness spans, the program's counters
and a profiled stretch of the window. The last line of standard output
is the result; the numbers compared for `correct` come last on standard
error too. Exits non-zero without a result when there is no card (or
fewer than the cell asks for) and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.find_cell(args.workload)
    harness.set_environment(cell.root)
    import rag_application_tpu_torch  # noqa: F401  the system under test
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = harness.driver_for(cell)
    outcome, setup_s = driver.run(cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda"),
                                  T_START)
    print("notes " + json.dumps(outcome.notes), file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    tr = outcome.readings.trace
    if args.trace:
        if tr is None:
            print("the traced run profiled nothing", file=sys.stderr)
            return 4
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
    line = harness.result_line(cell, outcome, bool(args.trace), setup_s,
                               device)
    for text in harness.check_lines(outcome):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
