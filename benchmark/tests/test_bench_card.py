"""On the card: every cell of BENCHMARK.json runs end to end, short, and
reads correct, with the result line's keys. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]])
def test_cell_runs_and_reads_correct(card, name):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "10", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"] and line["device"]["platform"] == "gpu"
