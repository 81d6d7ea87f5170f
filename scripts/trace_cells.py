#!/usr/bin/env python3
"""The cost of the program's tracer on a benchmark cell: one untraced
run of the cell's window, with the tracer off or held on throughout.

    python3 scripts/trace_cells.py --workload <cell> --seed <n> \\
        --seconds 30 --mode off|enabled

From the root of a checkout, on a machine with the card. ``enabled``
holds `TRACER.enable()` over the whole run, so every span of the search
entry, the funnel or the batcher is recorded; ``off`` runs it as the
benchmark does. Prints one JSON line: the cell's end-to-end metrics,
`setup_s`, and, with ``enabled``, the spans recorded.
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
    ap.add_argument("--mode", choices=("off", "enabled"), required=True)
    args = ap.parse_args(argv)

    cell = harness.find_cell(args.workload)
    harness.set_environment(cell.root)
    import torch

    from rag_application_tpu_torch.utils.observability import TRACER

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    handle = TRACER.enable() if args.mode == "enabled" else None
    try:
        outcome, setup_s = harness.driver_for(cell).run(
            cell, args.seed, args.seconds, False, device, T_START)
    finally:
        if handle is not None:
            handle.close()
    line = {"workload": cell.name, "seed": args.seed, "mode": args.mode,
            "correct": outcome.correct, "setup_s": setup_s,
            "device": torch.cuda.get_device_name(0),
            "end_to_end": outcome.end_to_end}
    if handle is not None:
        line["spans"] = len(TRACER.session())
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
