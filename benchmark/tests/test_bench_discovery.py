"""A configuration, a traffic mix and a per-layer metric added as new
files, with new entries in BENCHMARK.json and no edit to any file the
benchmark has, are found by name and run."""

import json
import os
import shutil
import time

import torch

from benchmark import harness

from .conftest import SEED


def test_new_config_mix_and_metric_are_found_and_run(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    before = {p: open(p, "rb").read()
              for p in map(str, (root / "benchmark").rglob("*.*"))}

    cfg = harness.load_json(str(root / "benchmark/configs/hybrid-1m768.json"))
    cfg.update(name="hybrid-8k256", rows=8192, dim=256,
               matryoshka_dims=[64, 128])
    (root / "benchmark/configs/hybrid-8k256.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/traffic/tiny-vectors.json").write_text(json.dumps({
        "driver": "search", "qps_metric": "search_qps", "why": "a test",
        "batch": 64,
        "pool_batches": 2, "noise": 0.05, "texts": False, "flip": 0.2,
        "sample": 32, "trace_batches": 1, "control_batches": 2,
        "limits": {"dense_miss": 0.03}}))
    (root / "benchmark/metrics/batches_done.py").write_text(
        'UNIT = "batches"\n\n\ndef read(r):\n'
        '    return r.work.get("batches")\n')
    bench["configs"].append({"name": "hybrid-8k256", "source": "a test",
                             "file": "benchmark/configs/hybrid-8k256.json",
                             "reduced": ["rows"], "why": "a test"})
    bench["workloads"].append({"name": "hybrid-8k256.tiny-vectors",
                               "config": "hybrid-8k256",
                               "traffic": "tiny-vectors", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("search_qps", "recall_at_10"):
            m["workloads"].append("hybrid-8k256.tiny-vectors")
    bench["per_layer"].append({
        "name": "batches_done", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "search entry",
        "moves": "search_qps", "workloads": ["hybrid-8k256.tiny-vectors"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("hybrid-8k256.tiny-vectors", root=str(root))
    assert cell.config["rows"] == 8192 and cell.mix["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["batches_done"]
    t0 = time.perf_counter()
    outcome, setup_s = harness.driver_for(cell).run(
        cell, SEED, 0.5, False, torch.device("cpu"), t0)
    assert outcome.correct
    device = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    line = harness.result_line(cell, outcome, True, setup_s, device)
    assert line["metrics"]["batches_done"]["value"] >= 1
    line = harness.result_line(cell, outcome, False, setup_s, device)
    assert set(line["metrics"]) == {"search_qps", "recall_at_10", "setup_s"}
    # nothing the benchmark had was edited
    for path, content in before.items():
        assert open(path, "rb").read() == content, path
