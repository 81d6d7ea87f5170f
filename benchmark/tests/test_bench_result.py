"""The result line: its keys, which metrics each kind of run carries,
and a per-layer metric that finds nothing to read."""

import json
import threading
import time

import pytest
import torch

from benchmark import harness

from .conftest import SEED, tiny_generate

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 123}


def _outcome(**kw):
    readings = harness.Readings(
        spans={"prepare": [0.1, 0.3], "batch": [0.2, 0.4, 0.3]},
        work={"queries": 8, "rows": 1024, "dim": 16, "prefix": 4,
              "batches": 3, "window_s": 1.0, "traced_batches": 2},
        trace=harness.Trace(
            [("void scan_int8_kernel<0>(x)", 0.0, 0.002),
             ("void scan_bf16_kernel<4>(x)", 0.003, 0.004),
             ("Memcpy HtoD", 0.006, 0.010)],
            [("prepare", 0.004, 0.006)], 0.010))
    base = dict(end_to_end={"search_qps": 24.0, "search_p95_ms": 390.0,
                            "recall_at_10": 0.99},
                readings=readings,
                checks=[("dense_miss", 0.01, 0.03)], correct=True,
                attempted=24, failed=0, memory_peak_bytes=123)
    base.update(kw)
    return harness.Outcome(**base)


def test_end_to_end_line_keys_and_order():
    cell = harness.find_cell("hybrid-1m768.vectors-8192")
    line = harness.result_line(
        cell, _outcome(end_to_end={"search_qps.vectors": 24.0,
                                   "search_p95_ms": 390.0,
                                   "recall_at_10": 0.99}),
        False, 12.5, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"search_qps.vectors", "search_p95_ms",
                                    "recall_at_10", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    assert line["checks"] == {"dense_miss": {"value": 0.01, "limit": 0.03}}
    json.dumps(line)


@pytest.mark.parametrize("name,split", [
    ("hybrid-1m768.mixed-8192", ""), ("hybrid-1m768.vectors-8192",
                                      ".vectors")])
def test_traced_line_carries_the_per_layer_metrics_and_breakdown(name,
                                                                  split):
    cell = harness.find_cell(name)
    line = harness.result_line(cell, _outcome(), True, 12.5, DEVICE)
    assert list(line)[-2:] == ["breakdown", "checks"]
    want = {"scan_roofline" + split, "search_mfu" + split,
            "device_idle_share" + (split or ".mixed")}
    if not split:
        want |= {"query_prep_ms", "batch_p95_ms.mixed"}
    assert set(line["metrics"]) == want
    m = line["metrics"]
    if not split:
        assert m["query_prep_ms"]["value"] == pytest.approx(200.0)
    # busy 7 ms of 10 (the scans' 3 ms and the copy's 4): idle 30%
    assert m["device_idle_share" + (split or ".mixed")]["value"] == \
        pytest.approx(30.0)
    ops = line["breakdown"]["device_ops"]
    assert ops[0][0].startswith("Memcpy") and len(ops) <= 10
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert gaps["prepare"] == pytest.approx(0.002)
    assert gaps["host"] == pytest.approx(0.001)


def test_a_listed_metric_that_reads_nothing_fails_the_run():
    cell = harness.find_cell("hybrid-1m768.mixed-8192")
    out = _outcome()
    out.readings.spans = {}
    with pytest.raises(RuntimeError, match="query_prep_ms"):
        harness.result_line(cell, out, True, 1.0, DEVICE)


def test_a_roofline_reader_reads_nothing_without_its_kernels():
    reader = harness.metric_reader("scan_roofline")
    out = _outcome()
    out.readings.trace.device_ops = [("Memcpy HtoD", 0.0, 1.0)]
    assert reader.read(out.readings) is None


def test_percentile():
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert harness.percentile(list(range(101)), 95) == 95.0
    assert harness.percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def test_traced_stretch_runs_on_until_decode_chunks(monkeypatch):
    """A stretch that falls where no row decodes (here a dispatch held
    back for twice the stretch, as a burst of admissions holds every row)
    runs on until two decode chunks were dispatched in it, so that the
    decode kernel has calls to read."""
    cell = tiny_generate()
    hold = 2 * cell.mix["trace_seconds"]
    calls, started, held = [], threading.Event(), []
    real = harness.profiler

    def profiler(device):
        calls.append(device)
        if len(calls) == 2:  # the first is the profiler's warm-up
            started.set()
        return real(device)

    def stall(batcher):
        step = batcher._step

        def held_step(*a, **k):
            if started.is_set() and not held:
                held.append(True)
                time.sleep(hold)
            return step(*a, **k)

        batcher._step = held_step

    monkeypatch.setattr(harness, "profiler", profiler)
    out, _ = harness.driver_for(cell).run(
        cell, SEED, 3.0, True, torch.device("cpu"), time.perf_counter(),
        fault=stall)
    assert held and out.correct
    assert out.notes["traced_steps"] >= 2 * cell.mix["batcher"]["chunk"]
    assert out.notes["traced_s"] > hold
