"""The readers of the program's spans (`benchmark/spans.py` and the six
metrics that use it) on hand-built readings: a profiled stretch and a
synthetic session of the port's tracer, placed by its markers. Each
reads the right value, and nothing without its spans. The six entries
they would take in BENCHMARK.json keep its form, and tiny traced runs of
each cell on the CPU give every one of them something to read."""

import copy
import time

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import test_bench_contract as contract
from rag_application_tpu_torch.utils import observability
from rag_application_tpu_torch.utils.observability import MARK, Tracer

from .conftest import SEED, tiny_generate, tiny_search

MIXED, VECTORS = "hybrid-1m768.mixed-8192", "hybrid-1m768.vectors-8192"
GEN = "mistral-7b-v0.2.rag-answers-32"
# the per_layer entries the six readers would take in BENCHMARK.json
ENTRIES = [
    {"name": "bm25_encode_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "search entry",
     "moves": "search_qps", "workloads": [MIXED]},
    {"name": "bm25_stage_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "funnel", "moves": "search_qps",
     "workloads": [MIXED]},
    {"name": "cascade_ms.vectors", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "funnel",
     "moves": "search_qps.vectors", "workloads": [VECTORS]},
    {"name": "admit_share.gen", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "continuous batcher",
     "moves": "gen_tokens_s", "workloads": [GEN]},
    {"name": "decode_idle_share.gen", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "model step",
     "moves": "gen_tokens_s", "workloads": [GEN]},
    {"name": "queue_wait_ms.gen", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "continuous batcher",
     "moves": "gen_tokens_s", "workloads": [GEN]},
]
OFF = 1_700_000_000_000_000_000  # the stretch's start on the ring's clock


def _span(seq, name, start_s, end_s, device_ms=None, **attrs):
    """A closed (or, with end_s None, open) span at seconds on the
    stretch's clock."""
    s = observability.Span(Tracer(), name, dict(attrs))
    s.seq, s.session = seq, 1
    s.start_ns = OFF + round(start_s * 1e9)
    s.end_ns = None if end_s is None else OFF + round(end_s * 1e9)
    s._device_ms = device_ms
    s.mark_ns = s.start_ns + 1000
    return s


def _readings(session, window_s, device_ops=(), marked=None):
    """Readings of a stretch whose host ops hold the markers of the spans
    in ``marked`` (default: all), each at its span's start."""
    marked = session if marked is None else marked
    host = [(MARK + str(s.seq), (s.start_ns - OFF) / 1e9,
             (s.start_ns - OFF) / 1e9 + 1e-6) for s in marked]
    host.append(("aten::mm", 0.0, 0.1))
    return harness.Readings(trace=harness.Trace(list(device_ops), host,
                                                window_s))


@pytest.fixture
def session(monkeypatch):
    """Sets the session the readers see."""
    box = []
    monkeypatch.setattr(spans, "session", lambda: list(box))
    return box


def _read(name, r):
    return harness.metric_reader(name).read(r)


def test_search_stage_readers(session):
    session += [
        _span(0, "search.encode", -0.5, -0.3, batch=1),  # before: out
        _span(1, "search.prepare", 0.01, 0.2, batch=2),
        _span(2, "search.encode", 0.02, 0.12, batch=2),
        _span(3, "search.bm25", 0.3, 0.4, device_ms=20.0, batch=2),
        _span(4, "search.cascade", 0.21, 0.25, device_ms=9.0, batch=2),
        _span(5, "search.encode", 1.0, 1.12, batch=3),
        _span(6, "search.bm25", 1.2, 1.25, device_ms=30.0, batch=3),
        _span(7, "search.cascade", 1.13, 1.14, batch=3),  # no events
    ]
    r = _readings(session, 2.0)
    assert _read("bm25_encode_ms", r) == pytest.approx(110.0)
    assert _read("bm25_stage_ms", r) == pytest.approx(25.0)
    # device time where the span has events, host time where not
    assert _read("cascade_ms.vectors", r) == pytest.approx(9.5)


def test_batcher_readers(session):
    session += [
        _span(0, "batcher.dispatch", 0.5, 0.6, chunk=0, rows=4),
        _span(1, "batcher.readback", 0.6, 2.0, chunk=0),
        _span(2, "batcher.dispatch", 1.5, 1.6, chunk=1, rows=4),
        _span(3, "batcher.readback", 1.6, 3.0, chunk=1),
        _span(4, "batcher.dispatch", 9.8, 9.9, chunk=2),  # no readback
        _span(5, "batcher.admit", 2.5, 3.5, rid=4),
        _span(6, "batcher.admit", 3.0, 4.0, rid=5),
        _span(7, "batcher.admit", 9.0, 11.0, rid=6),
        _span(8, "batcher.queue", -1.0, 2.5, rid=4),
        _span(9, "batcher.queue", 2.0, 3.0, rid=5),
        _span(10, "batcher.queue", 7.0, 9.0, rid=6),
        _span(11, "batcher.queue", 9.5, None, rid=7),  # still waiting
    ]
    busy = [("k", 0.5, 1.0), ("k", 0.9, 1.2), ("k", 1.4, 2.0)]
    r = _readings(session, 10.0, busy, marked=session[:1])
    # admissions cover [2.5, 4] and [9, 10] of the 10 s
    assert _read("admit_share.gen", r) == pytest.approx(25.0)
    # decoding [0.5, 2.5] (chunk 2 has no readback; [2.5, 3] admits):
    # idle [1.2, 1.4] and [2.0, 2.5] of 2 s
    assert _read("decode_idle_share.gen", r) == pytest.approx(35.0)
    assert _read("queue_wait_ms.gen", r) == pytest.approx(2000.0)


def test_queue_wait_without_an_admission_in_the_stretch(session):
    session += [_span(0, "batcher.dispatch", 0.1, 0.2, chunk=0),
                _span(1, "batcher.queue", 6.0, None, rid=1),
                _span(2, "batcher.queue", 7.0, 12.0, rid=2)]
    # queued at the close (10 s): counted to it
    assert _read("queue_wait_ms.gen", _readings(session, 10.0)) == \
        pytest.approx(3500.0)
    del session[1:]
    assert _read("queue_wait_ms.gen", _readings(session, 10.0)) == 0.0


def test_admit_share_without_an_admission_in_the_stretch(session):
    session += [_span(0, "batcher.dispatch", 0.1, 0.2, chunk=0),
                _span(1, "batcher.readback", 0.2, 0.9, chunk=0)]
    assert _read("admit_share.gen", _readings(session, 10.0)) == 0.0


@pytest.mark.parametrize("name", [e["name"] for e in ENTRIES])
def test_a_reader_reads_nothing_without_its_spans(session, name):
    other = _span(0, "t.other", 0.1, 0.2)
    assert _read(name, _readings([], 1.0)) is None
    session.append(other)
    assert _read(name, _readings(session, 1.0)) is None
    assert _read(name, harness.Readings()) is None  # no profiled stretch


def test_no_session_without_the_tracer_or_its_markers(monkeypatch,
                                                      session):
    session.append(_span(0, "search.encode", 0.1, 0.2, batch=1))
    assert _read("bm25_encode_ms",
                 _readings(session, 1.0, marked=[])) is None
    monkeypatch.undo()
    monkeypatch.delattr(observability, "TRACER")
    assert spans.session() == []


def test_interval_arithmetic():
    assert spans.union([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2),
                                                               (3, 4)]
    assert spans.clip([(-1, 1), (2, 9)], 0, 5) == [(0, 1), (2, 5)]
    assert spans.subtract([(0, 10)], [(1, 2), (5, 12)]) == [(0, 1),
                                                             (2, 5)]
    assert spans.length([(0, 1), (2, 5)]) == 4


def test_the_six_entries_keep_the_form_of_benchmark_json(monkeypatch):
    bench = copy.deepcopy(contract.BENCH)
    bench["per_layer"] += copy.deepcopy(ENTRIES)
    monkeypatch.setattr(contract, "BENCH", bench)
    for test in (contract.test_top_level_keys_and_command,
                 contract.test_metrics,
                 contract.test_every_file_name_is_made_of_name_characters):
        test()
    for e in ENTRIES:
        reader = harness.metric_reader(e["name"])
        assert reader.UNIT == e["unit"]


@pytest.mark.parametrize("cell,names", [
    (MIXED, ("bm25_encode_ms", "bm25_stage_ms")),
    (VECTORS, ("cascade_ms.vectors",)),
    (GEN, ("admit_share.gen", "decode_idle_share.gen",
           "queue_wait_ms.gen"))])
def test_traced_cells_give_the_readers_their_spans(cell, names):
    """Tiny traced runs through the cells' drivers, on the CPU: each
    reader finds its spans in the profiled stretch."""
    c = tiny_generate() if cell == GEN else tiny_search(cell)
    out, _ = harness.driver_for(c).run(
        c, SEED, 6.0, True, torch.device("cpu"), time.perf_counter())
    assert out.correct and out.readings.trace is not None
    for name in names:
        value = _read(name, out.readings)
        assert value is not None and value >= 0, name
    marks = [n for n, _, _ in out.readings.trace.host_ops
             if n.startswith(MARK)]
    assert marks
