"""BENCHMARK.json keeps the form the benchmark's checker takes: its keys,
names, units, lengths, files and the time a full check needs."""

import json
import os
import re

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs_files_and_reduced():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert cfg["source"] == c["source"]


def test_workloads():
    pairs, names = set(), set()
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in names
        assert NAME.match(w["traffic"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == configs
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = set(e2e)
    for m in BENCH["per_layer"]:
        # every per-layer metric lists its cells: a reader that finds
        # nothing there fails the run
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m.get("workloads", cells):
            # the cell reports the end-to-end metric this one moves
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cells
        assert m["name"] not in names or m in BENCH["end_to_end"]
        names.add(m["name"])
    for w in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_every_file_name_is_made_of_name_characters():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    json.dumps(BENCH)
