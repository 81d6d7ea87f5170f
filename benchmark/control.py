#!/usr/bin/env python3
"""Readings that set a cell's limits: the control, the plain reference
one precision step below the configuration's put in the program's place,
judged by the cell's own comparison at the cell's own sizes.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \\
        [--seconds 30]

Search cells: int8 dense scores in place of the bf16 plane's (and, with
texts, BM25 weights summed in bf16 in place of the exact scores), on the
cell's sample of queries, no program run. The generation cell: one
program run of ``--seconds`` per seed, then its judged requests read
again with int4 weights in the reference. Prints one JSON line a seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.set_environment(cell.root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    driver = harness.driver_for(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.mix["driver"] == "generate":
            outcome, _ = driver.run(cell, seed, args.seconds, False, dev, t0)
            control = driver.judge(cell.config, seed, outcome.judged, dev,
                                   bits=4)
            row = {"program": {n: v for n, v, _ in outcome.checks},
                   "control": {"served_logit_gap": control},
                   "served_tokens": sum(len(r.tokens)
                                        for r in outcome.judged),
                   "correct": outcome.correct, "notes": outcome.notes,
                   "end_to_end": outcome.end_to_end}
        else:
            row = {"control": {n: v for n, v, _ in
                               driver.control_checks(cell, seed, dev)}}
        row.update(workload=cell.name, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
