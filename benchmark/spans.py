"""The program's own spans, for the per-layer readers: the latest session
of the port's tracer (`rag_application_tpu_torch/utils/observability.py::
TRACER`, on while the profiler runs, so it holds the profiled stretch),
placed on the stretch's clock by the markers the profiler recorded, and
the interval arithmetic the readers share.

A program without the tracer, or a session without a marker on the
trace, gives no spans, and a reader then reads nothing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def session() -> list:
    """The tracer's latest session, or [] in a program without one."""
    try:
        from rag_application_tpu_torch.utils import observability
    except ImportError:
        return []
    tracer = getattr(observability, "TRACER", None)
    return tracer.session() if tracer is not None else []


def placed(r, names: Sequence[str]) -> List[Tuple[object, float, float]]:
    """The session's spans named ``names`` that overlap the profiled
    stretch, as (span, start_s, end_s) on the trace's clock, where the
    stretch is [0, window_s]; an open span ends at the stretch's end."""
    if r.trace is None:
        return []
    spans = session()
    if not spans:
        return []
    from rag_application_tpu_torch.utils.observability import on_trace_clock

    on = on_trace_clock(spans, r.trace.host_ops) or []
    end_s = r.trace.window_s
    out = []
    for span, s, e in on:
        e = end_s if e is None else e
        if span.name in names and e > 0.0 and s < end_s:
            out.append((span, s, e))
    return out


def per_batch_ms(r, name: str, device: bool) -> Optional[float]:
    """Mean over the stretch's search batches of the time in spans named
    ``name`` a batch (ms): their device intervals where the span has
    CUDA events (``device``), else their host time."""
    by: Dict[object, float] = {}
    for span, s, e in placed(r, (name,)):
        if span.end_ns is None or s < 0.0:
            continue
        ms = span.device_ms if device else None
        if ms is None:
            ms = span.duration_ns / 1e6
        key = span.attrs.get("batch")
        by[key] = by.get(key, 0.0) + ms
    if not by:
        return None
    return sum(by.values()) / len(by)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint sorted intervals covering the same points."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return union((max(a, lo), min(b, hi)) for a, b in intervals)


def subtract(a: Sequence[Interval], b: Sequence[Interval]
             ) -> List[Interval]:
    """The points of ``a`` outside ``b`` (both disjoint and sorted)."""
    out: List[Interval] = []
    for lo, hi in a:
        cur = lo
        for blo, bhi in b:
            if bhi <= cur or blo >= hi:
                continue
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
        if cur < hi:
            out.append((cur, hi))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)
