"""What every cell shares: finding a cell's files by name, the guard
against JAX, statistics, the reading of a profiler trace, and the
result line.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
configuration is `benchmark/configs/<config>.json`; the mix is
`benchmark/traffic/<traffic>.json`, whose `driver` names the general
driver in `benchmark/drivers/<driver>.py` that reads it; a per-layer
metric is `benchmark/metrics/<metric>.py`, a reader of its own. A new
configuration, mix or metric is a new file and a new entry, no edit.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = "benchmark"
# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_application_tpu")
# the port's caches, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/bench_cache/triton",
              "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions"}


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module from a file (names may hold dots: `device_idle_share.gen`)."""
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and mix."""
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    bench: Dict[str, Any]
    root: str = ROOT

    @property
    def end_to_end(self) -> List[Dict[str, Any]]:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    @property
    def per_layer(self) -> List[Dict[str, Any]]:
        """The per-layer metrics that list this cell in `workloads`."""
        return [m for m in self.bench["per_layer"]
                if self.name in m["workloads"]]

    def reports(self, metric: Dict[str, Any]) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def find_cell(name: str, root: str = ROOT,
              bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(root, configs[w["config"]]["file"]))
    mix = load_json(os.path.join(root, BENCH_DIR, "traffic",
                                 w["traffic"] + ".json"))
    return Cell(name, int(w["chips"]), cfg, mix, bench, root)


def driver_for(cell: Cell):
    return load_module(os.path.join(cell.root, BENCH_DIR, "drivers",
                                    cell.mix["driver"] + ".py"))


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, BENCH_DIR, "metrics",
                                    name + ".py"))


def set_environment(root: str = ROOT) -> None:
    """Caches at fixed paths in the checkout; no library loads JAX."""
    for var, rel in CACHE_DIRS.items():
        path = os.path.join(root, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# ------------------------------------------------------------- statistics


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# ------------------------------------------------------------------ trace


def profiler(device):
    """A profiler of the host and, on the card, the device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def warm_profiler(device) -> None:
    """The profiler's own start-up, paid in set-up and not in the window."""
    import torch

    with profiler(device):
        torch.zeros(1, device=device).add_(1)


@dataclass
class Trace:
    """A profiled stretch: device operations and host ops as (name,
    start_s, end_s) on one clock, and the stretch's length on the host
    clock."""
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float

    @classmethod
    def from_profiler(cls, prof, window_s: float,
                      annotations: Sequence[str] = ()) -> "Trace":
        """``annotations``: the harness's own `record_function` names,
        which the profiler mirrors as device ranges; they are host spans
        and not device operations."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            item = (e.name, tr.start / 1e6, tr.end / 1e6)
            if e.device_type == DeviceType.CUDA:
                if e.name not in annotations:
                    dev.append(item)
            elif e.device_type == DeviceType.CPU and e.cpu_parent is None:
                host.append(item)
        return cls(dev, host, window_s)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union
        of the operations' intervals)."""
        busy, end = 0.0, -math.inf
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def matching(self, patterns: Sequence[str]) -> List[Tuple[str, float,
                                                              float]]:
        return [o for o in self.device_ops
                if any(p in o[0] for p in patterns)]

    def seconds_of(self, patterns: Sequence[str]) -> float:
        return sum(e - s for _, s, e in self.matching(patterns))

    def top_ops(self, n: int = 10) -> List[List[Any]]:
        """The device operations that took most time, by name."""
        by: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> List[List[Any]]:
        """The device's idle gaps, added up by the outermost host op
        running at each gap's middle ("host" where none ran)."""
        ops = sorted(self.device_ops, key=lambda x: x[1])
        host = sorted(self.host_ops, key=lambda x: x[1])
        starts = [h[1] for h in host]
        by: Dict[str, float] = {}
        end = ops[0][2] if ops else 0.0
        for _, s, e in ops[1:]:
            if s > end:
                mid = (s + end) / 2
                i = bisect.bisect_right(starts, mid)
                # outermost ops of a thread do not nest: a few back suffice
                name = next((h[0] for h in reversed(host[max(0, i - 64):i])
                             if h[2] >= mid), "host")
                by[name] = by.get(name, 0.0) + (s - end)
            end = max(end, e)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]


@dataclass
class Readings:
    """What the per-layer readers read: harness spans (seconds) around
    calls into a layer, the program's counters over the window, the
    profiled stretch, and the work as shapes."""
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None
    work: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Outcome:
    """A driver's run: end-to-end values, readings for the per-layer
    metrics, and the correctness comparison."""
    end_to_end: Dict[str, float]
    readings: Readings
    checks: List[Tuple[str, float, float]]
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: Dict[str, Any] = field(default_factory=dict)
    # what was judged, for the control to be read on the same answers
    judged: Any = None


# ----------------------------------------------------------------- result


def per_layer_values(cell: Cell, readings: Readings
                     ) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell from its reader. A metric that
    reads nothing fails the run: it never reads 0."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.root).read(readings)
        if value is None:
            raise RuntimeError(f"per-layer metric {m['name']} found "
                               f"nothing to read in {cell.name}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, trace: bool, setup_s: float,
                device: Dict[str, Any]) -> Dict[str, Any]:
    if trace:
        metrics = per_layer_values(cell, outcome.readings)
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"{cell.name} did not measure "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": bool(outcome.correct),
            "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    tr = outcome.readings.trace
    if trace and tr is not None:
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    return line


def check_lines(outcome: Outcome) -> List[str]:
    return [f"check {name}: {value!r} (limit {limit!r}) "
            f"{'ok' if value <= limit else 'FAILED'}"
            for name, value, limit in outcome.checks]
