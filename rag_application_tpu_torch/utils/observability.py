"""Observability: metrics registry, stage timing journal, device tracing.

Copy of `rag_application_tpu/utils/observability.py`; `device_trace`
wraps `torch.profiler` instead of `jax.profiler`.

  * `Metrics` — process-wide counters/gauges/histograms with a
    Prometheus-style text exposition.
  * `stage_timer` — context manager feeding per-stage latency histograms.
  * `device_trace` — `torch.profiler` trace (CPU + CUDA activity) written
    as a Chrome trace for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

_BUCKETS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
            0.5, 1.0, 2.5, 5.0, 10.0]


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], List[float]] = defaultdict(
            lambda: [0.0] * (len(_BUCKETS) + 1))
        self._hist_sum: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._hist_count: Dict[Tuple[str, Tuple], int] = defaultdict(int)

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._counters[self._key(name, labels)] += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            hist = self._hists[key]
            for i, b in enumerate(_BUCKETS):
                if value <= b:
                    hist[i] += 1
                    break
            else:
                hist[-1] += 1
            self._hist_sum[key] += value
            self._hist_count[key] += 1

    @contextlib.contextmanager
    def stage_timer(self, stage: str, **labels) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe("stage_seconds", time.perf_counter() - t0,
                         stage=stage, **labels)

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        """Approximate quantile from histogram buckets."""
        key = self._key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            count = self._hist_count.get(key, 0)
        if not hist or not count:
            return None
        target = q * count
        acc = 0.0
        for i, c in enumerate(hist):
            acc += c
            if acc >= target:
                return _BUCKETS[i] if i < len(_BUCKETS) else math.inf
        return math.inf

    def render(self) -> str:
        """Prometheus text exposition."""
        lines: List[str] = []

        def fmt_labels(label_items, extra=""):
            parts = [f'{k}="{v}"' for k, v in label_items]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"{name}_total{fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                lines.append(f"{name}{fmt_labels(labels)} {v}")
            for (name, labels), hist in sorted(self._hists.items()):
                acc = 0.0
                for i, b in enumerate(_BUCKETS):
                    acc += hist[i]
                    lines.append(
                        f"{name}_bucket{fmt_labels(labels, f'le=\"{b}\"')} {acc}")
                acc += hist[-1]
                lines.append(
                    f"{name}_bucket{fmt_labels(labels, 'le=\"+Inf\"')} {acc}")
                lines.append(f"{name}_sum{fmt_labels(labels)} "
                             f"{self._hist_sum[(name, labels)]}")
                lines.append(f"{name}_count{fmt_labels(labels)} "
                             f"{self._hist_count[(name, labels)]}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace (CPU + CUDA activity) written to
    ``log_dir/trace.json`` for kernel-level timing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    import torch

    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
