"""Observability: the metrics registry and the program's tracer.

The `Metrics` registry is a copy of `rag_application_tpu/utils/
observability.py`'s; the tracer is the port's own.

  * `Metrics` — process-wide counters/gauges/histograms with a
    Prometheus-style text exposition; `stage_timer` feeds per-stage
    latency histograms.
  * `Tracer` (`TRACER`) — spans of the program's layers (the search
    entry, the funnel's stages, the continuous batcher) in a bounded
    ring: name, thread, parent (the span open around it in the same
    thread and asyncio task), start and end on the monotonic
    `time.perf_counter_ns()` clock, attributes with the request's
    identifier (`batch` for a search batch, `rid` for a batcher request,
    `chunk` for a decode chunk), and, for a span given a CUDA `device`,
    the device interval between two events on the current stream.

Tracing is on while `TRACER.enable()` is in force (an operator's switch:
a handle to `close()`, or a `with` block) and whenever a torch
profiler runs (`torch.autograd.profiler._is_profiler_enabled`, a
process-wide flag, so spans of executor threads count too). Off, a span
costs one flag check and records nothing. Each turn from off to on
starts a new session; `TRACER.session()` gives the latest. The turn is
seen by the spans themselves: a span, or the end of `enable()`, that
finds tracing off closes the session, so two profiler sessions with no
span run between them share one. While tracing
is on, every closed span is also observed in `METRICS`'
``stage_seconds{stage=<name>}``.

Placing spans on a profiler trace: while the profiler records the
current thread, each span's start emits a zero-length `record_function`
marker ``tracer.mark:<seq>``. It launches nothing, so the profiler gives
it no device range. A marker at the top level of the trace gives the
trace's start on the ring's clock (the offset between the two clocks);
`on_trace_clock` maps a session's spans onto the trace's timeline with
them. The ring's clock never steps, so a wall-clock step from NTP moves
no duration.
"""

from __future__ import annotations

import contextvars
import itertools
import math
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

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

    def stage_timer(self, stage: str, **labels) -> "Span":
        """`TRACER.span(stage)` that also feeds this registry's
        ``stage_seconds{stage=<stage>, **labels}`` when tracing is off."""
        return Span(TRACER, stage, dict(labels), metrics=(self, labels))

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


# ------------------------------------------------------------------ tracer

MARK = "tracer.mark:"
# a marker whose two stamps lie further apart (the thread was switched
# out between them) gives no clock offset; the offsets it keeps agree
# within this
MARK_SLACK_NS = 100_000
# attributes that name a span's request; a child takes them from its parent
_KEYS = ("batch", "rid", "chunk")
# a zero-length host range with no child op (record_function's enter is
# itself an op); older torch has only record_function
_Marker = getattr(torch._C._profiler, "_RecordFunctionFast",
                  _profiler.record_function)
_thread_profiled = torch._C._autograd._profiler_enabled
# the innermost open `with` span; a context variable, so each thread and
# each asyncio task sees its own (coroutines interleave on one thread)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("span",
                                                         default=None)


class Span:
    """One timed stretch of the program. ``end_ns`` is None while the
    span is open; ``parent`` is the ``seq`` of the span open around it in
    the same thread and asyncio task, if any."""

    __slots__ = ("name", "attrs", "seq", "session", "tid", "parent",
                 "start_ns", "end_ns", "_tracer", "_recorded", "_events",
                 "_device_ms", "_metrics", "_up", "mark_ns")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 device=None, metrics=None):
        self.name, self.attrs, self._tracer = name, attrs, tracer
        self.seq, self.session, self.parent = -1, -1, None
        self.tid = threading.get_ident()
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self._recorded = False
        self._up: Any = False  # the span around it while nested in it
        self.mark_ns: Optional[int] = None  # after the span's marker
        self._events = None
        self._device_ms: Optional[float] = None
        self._metrics = metrics
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            self._events = (stream, torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def _begin(self, nested: bool) -> "Span":
        t = self._tracer
        up = _CURRENT.get()
        if up is not None:
            if up._recorded:
                self.parent = up.seq
            for k in _KEYS:
                if k in up.attrs and k not in self.attrs:
                    self.attrs[k] = up.attrs[k]
        if nested:
            self._up = up
            _CURRENT.set(self)
        if t.on:
            t._add(self)
        else:
            t._live = False
        self.start_ns = time.perf_counter_ns()
        if self._recorded and _thread_profiled():
            with _Marker(MARK + str(self.seq)):
                pass
            self.mark_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._events[0])
        return self

    def __enter__(self) -> "Span":
        return self._begin(True)

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def close(self) -> None:
        """End the span (once). A span begun while tracing was off and
        ended while it is on is recorded now, into the current session."""
        if self.end_ns is not None:
            return
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[2].record(self._events[0])
        if self._up is not False:
            if _CURRENT.get() is self:
                _CURRENT.set(self._up)
            self._up = False
        if not self._recorded and self._tracer.on:
            self._tracer._add(self)
        seconds = (self.end_ns - self.start_ns) / 1e9
        if self._metrics is not None:
            registry, labels = self._metrics
            registry.observe("stage_seconds", seconds, stage=self.name,
                             **labels)
        elif self._recorded:
            METRICS.observe("stage_seconds", seconds, stage=self.name)

    @property
    def duration_ns(self) -> Optional[int]:
        return None if self.end_ns is None else self.end_ns - self.start_ns

    @property
    def device_ms(self) -> Optional[float]:
        """The device time between the span's two events, read (and
        waited for) on first use; None without events or while open."""
        if self._device_ms is None and self._events is not None \
                and self.end_ns is not None:
            _, start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms


class _Off:
    """What `span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Enabled:
    """Keeps tracing on until closed (once), or to the end of a `with`."""

    def __init__(self, tracer: "Tracer"):
        self._tracer, self._open = tracer, True

    def __enter__(self) -> "Tracer":
        return self._tracer

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        if self._open:
            self._open = False
            t = self._tracer
            with t._lock:
                t._forced -= 1
                if not t.on:
                    t._live = False


class Tracer:
    """The program's spans in a bounded ring (module docstring)."""

    def __init__(self, capacity: int = 65536):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._forced = 0
        self._live = False  # tracing was on at the last span
        self.session_id = 0

    @property
    def on(self) -> bool:
        return bool(self._forced) or _profiler._is_profiler_enabled

    def span(self, name: str, device=None, **attrs):
        """A context manager timing its block. ``device``: record the
        block's device interval with CUDA events on that device's current
        stream (ignored off CUDA). Off, returns a shared no-op."""
        if not (self._forced or _profiler._is_profiler_enabled):
            self._live = False
            return _OFF
        return Span(self, name, attrs, device)

    def open(self, name: str, **attrs) -> Span:
        """A span begun now and ended by `Span.close`, from any thread or
        task (a request's wait in a queue). Made whether tracing is on or
        not, so that one ended while it is on is recorded."""
        return Span(self, name, attrs)._begin(False)

    def enable(self) -> _Enabled:
        """Turn tracing on until the handle is closed (or its `with`
        ends). From off, the next span starts a new session."""
        with self._lock:
            if not self.on:
                self._live = False
            self._forced += 1
        return _Enabled(self)

    def session(self) -> List[Span]:
        """The latest session's spans, in the order they were begun."""
        with self._lock:
            ring = list(self._ring)
            n = self.session_id
        return [s for s in ring if s.session == n]

    def _add(self, span: Span) -> None:
        with self._lock:
            if not self._live:
                self._live = True
                self.session_id += 1
            span.seq = next(self._seq)
            span.session = self.session_id
            span._recorded = True
            self._ring.append(span)


TRACER = Tracer()


def marker_offsets(spans: Sequence[Span],
                   host_ops: Sequence[Tuple[str, float, float]]
                   ) -> List[int]:
    """For each of ``spans``' markers among ``host_ops`` ((name, start_s,
    end_s) relative to a profiler trace's start): the ns to subtract from
    a span's stamp to put it on the trace's clock. The span's start and
    `mark_ns` enclose its marker; a pair further apart than
    `MARK_SLACK_NS` gives none."""
    by_seq = {s.seq: s for s in spans
              if s.mark_ns is not None
              and s.mark_ns - s.start_ns <= MARK_SLACK_NS}
    out = []
    for name, start, _ in host_ops:
        if name.startswith(MARK):
            s = by_seq.get(int(name[len(MARK):]))
            if s is not None:
                out.append(s.start_ns - round(start * 1e9))
    return out


def on_trace_clock(spans: Sequence[Span],
                   host_ops: Sequence[Tuple[str, float, float]]
                   ) -> Optional[List[Tuple[Span, float, Optional[float]]]]:
    """Each span with its start and end in seconds on a profiler trace's
    timeline (end None while open), by the median offset of the markers
    found at the trace's top level (``host_ops``); None without one."""
    offsets = marker_offsets(spans, host_ops)
    if not offsets:
        return None
    off = statistics.median(offsets)
    return [(s, (s.start_ns - off) / 1e9,
             None if s.end_ns is None else (s.end_ns - off) / 1e9)
            for s in spans]
