"""The port's tracer (`utils/observability.py::TRACER`) and the spans
and counters of the search entry, the funnel and the continuous batcher,
on the CPU.

Off, a span records nothing and `/metrics` does not change. On (by
`TRACER.enable()`, or while a torch profiler runs, from any thread), a
session holds each span with its parent and its request's identifier;
the profiler's top-level markers put the spans on the trace's clock.
Tracing changes no result: the searcher and the batcher give the same
answers with it on and off.
"""

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rag_application_tpu_torch.config import (FunnelConfig, IndexConfig,
                                              SparseConfig)
from rag_application_tpu_torch.index.analyzer import Analyzer
from rag_application_tpu_torch.index.dense import DenseIndex
from rag_application_tpu_torch.index.sparse import SparseIndex
from rag_application_tpu_torch.llm.scheduler import ContinuousBatcher
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.search.fused import FusedSearcher
from rag_application_tpu_torch.utils.observability import (
    MARK, METRICS, TRACER, Metrics, marker_offsets, on_trace_clock)


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts from tracing off: a span that finds it off closes
    the session before (two profiler sessions with no span run between
    them would share one)."""
    assert not TRACER.on
    with TRACER.span("t.off"):
        pass


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _top_level(prof):
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events() if e.cpu_parent is None]


def _names(spans):
    return [s.name for s in spans]


# ------------------------------------------------------------- the tracer


def test_off_records_nothing_and_leaves_metrics_alone():
    assert not TRACER.on
    before_render, before_session = METRICS.render(), TRACER.session()
    with TRACER.span("t.off", batch=1) as sp:
        sp.set(extra=2)
    TRACER.open("t.off.open", rid=3).close()
    assert METRICS.render() == before_render
    assert TRACER.session() == before_session


def test_enable_records_nesting_parents_and_request_ids():
    with TRACER.enable():
        with TRACER.span("t.outer", rid=7) as outer:
            with TRACER.span("t.inner") as inner:
                inner.set(note="x")
            with TRACER.span("t.other", rid=8):
                pass
        with TRACER.span("t.next", batch=2):
            pass
    spans = TRACER.session()
    assert _names(spans) == ["t.outer", "t.inner", "t.other", "t.next"]
    by = {s.name: s for s in spans}
    assert by["t.inner"].parent == outer.seq
    assert by["t.inner"].attrs == {"rid": 7, "note": "x"}  # inherited
    assert by["t.other"].attrs == {"rid": 8}  # its own wins
    assert by["t.next"].parent is None
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    assert by["t.outer"].start_ns <= inner.start_ns <= inner.end_ns \
        <= by["t.outer"].end_ns
    assert inner.device_ms is None  # no events off CUDA
    assert 'stage_seconds_count{stage="t.inner"}' in METRICS.render()
    assert not TRACER.on


@pytest.mark.parametrize("tracing", ["off", "on"])
def test_spans_of_interleaved_tasks_keep_their_own_parents(tracing):
    """Tasks on one loop close their spans out of order (the ingest
    pipeline's `stage_timer` around an await): each task's spans nest in
    its own, and none stays open around what runs after them."""
    m = Metrics()

    async def task(name, started, go):
        with m.stage_timer(name):
            started.set()
            await go.wait()
            with TRACER.span(name + ".child"):
                pass

    async def main():
        a_in, b_in, a_go, b_go = (asyncio.Event() for _ in range(4))
        a = asyncio.create_task(task("t.a", a_in, a_go))
        await a_in.wait()
        b = asyncio.create_task(task("t.b", b_in, b_go))
        await b_in.wait()
        a_go.set()  # a ends while b, begun after it, is still open
        await a
        b_go.set()
        await b

    with TRACER.enable() if tracing == "on" else TRACER.span("t.off"):
        asyncio.run(main())
    first = TRACER.session()
    with TRACER.enable():
        with TRACER.span("t.after") as after:
            pass
    assert after.parent is None and after.attrs == {}
    if tracing == "on":
        by = {s.name: s for s in first}
        assert by["t.a.child"].parent == by["t.a"].seq
        assert by["t.b.child"].parent == by["t.b"].seq


def test_a_handle_keeps_tracing_on_until_closed():
    handle = TRACER.enable()
    try:
        assert TRACER.on
        with TRACER.span("t.handle"):
            pass
    finally:
        handle.close()
    handle.close()  # once only
    assert not TRACER.on and _names(TRACER.session()) == ["t.handle"]


def test_open_span_begun_off_and_closed_on_joins_the_session():
    waiting = TRACER.open("t.queue", rid=5)
    with TRACER.enable():
        with TRACER.span("t.admit", rid=5):
            waiting.close()
    spans = {s.name: s for s in TRACER.session()}
    assert set(spans) == {"t.queue", "t.admit"}
    assert spans["t.queue"].start_ns < spans["t.admit"].start_ns \
        <= spans["t.queue"].end_ns


def test_stage_timer_is_a_span_that_always_feeds_its_registry():
    m = Metrics()
    with m.stage_timer("encode", task_type="doc"):
        time.sleep(0.001)
    assert 'stage_seconds_count{stage="encode",task_type="doc"} 1' \
        in m.render()
    with TRACER.enable():
        with m.stage_timer("encode", task_type="doc"):
            pass
    assert 'stage_seconds_count{stage="encode",task_type="doc"} 2' \
        in m.render()
    (span,) = TRACER.session()
    assert span.name == "encode" and span.attrs == {"task_type": "doc"}


def test_a_wall_clock_step_moves_no_duration(monkeypatch):
    """Spans and `stage_timer` time on a clock that never steps: the wall
    clock jumping back an hour inside a span changes nothing."""
    wall = iter(range(10**18, 0, -3_600 * 10**9))
    monkeypatch.setattr(time, "time_ns", lambda: next(wall))
    m = Metrics()
    with TRACER.enable():
        with m.stage_timer("ingest"):
            time.sleep(0.001)
        with TRACER.span("t.step"):
            time.sleep(0.001)
    spans = TRACER.session()
    assert _names(spans) == ["ingest", "t.step"]
    assert all(1e6 <= s.duration_ns < 1e9 for s in spans)
    assert 'stage_seconds_bucket{stage="ingest",le="0.0005"} 0.0' \
        in m.render()


def test_profiler_turns_tracing_on_for_executor_threads():
    def work(i):
        with TRACER.span("t.thread", chunk=i):
            time.sleep(0.001)

    with ThreadPoolExecutor(2) as ex:
        with _profile():
            assert TRACER.on
            for i in range(3):
                with TRACER.span("t.loop", batch=i):
                    ex.submit(work, i).result()
    assert not TRACER.on
    spans = TRACER.session()
    assert _names(spans) == ["t.loop", "t.thread"] * 3
    loops = [s for s in spans if s.name == "t.loop"]
    threads = [s for s in spans if s.name == "t.thread"]
    assert {s.tid for s in threads} != {loops[0].tid}
    # another thread's span has no parent there
    assert all(s.parent is None for s in threads)
    assert [s.attrs["chunk"] for s in threads] == [0, 1, 2]


def test_markers_put_spans_on_the_profiler_clock():
    """Each span begun on a profiled thread leaves a marker: a top-level
    host op with no child, at the span's start on the trace's clock."""
    with _profile() as prof:
        for i in range(6):
            with TRACER.span("t.step", batch=i):
                torch.randn(32, 32) @ torch.randn(32, 32)
            time.sleep(0.002)
    spans = TRACER.session()
    ops = _top_level(prof)
    marks = [e for e in prof.events() if e.name.startswith(MARK)]
    assert len(marks) == 6
    assert all(e.cpu_parent is None and not e.cpu_children for e in marks)
    assert all(e.time_range.end - e.time_range.start < 1e3 for e in marks)
    offsets = marker_offsets(spans, ops)
    assert len(offsets) >= 3 and max(offsets) - min(offsets) < 1e6
    placed = on_trace_clock(spans, ops)
    mm = {int(e.name[len(MARK):]): e.time_range.start / 1e6 for e in marks}
    for span, start, end in placed:
        assert abs(start - mm[span.seq]) < 1e-3
        assert end - start == pytest.approx(span.duration_ns / 1e9,
                                            abs=1e-6)
    # the matmul each span wraps lies inside it on the trace
    mms = sorted(s for n, s, _ in ops if n == "aten::matmul")
    for (_, start, end), t in zip(placed, mms):
        assert start - 1e-3 <= t <= end + 1e-3
    assert on_trace_clock(spans, [("aten::mm", 0.0, 1.0)]) is None


def test_a_second_profiler_session_replaces_the_first():
    with _profile():
        with TRACER.span("t.first"):
            pass
    first = TRACER.session_id
    with TRACER.span("t.between"):  # off: the session closes
        pass
    with _profile():
        with TRACER.span("t.second"):
            pass
    assert TRACER.session_id == first + 1
    assert _names(TRACER.session()) == ["t.second"]


# ------------------------------------------------------------- the search

N, D, CAP, VOCAB, Q = 300, 64, 384, 400, 5
FUNNEL = dict(matryoshka_limits=(24, 16), dense_limit=12, quantized_limit=16,
              sparse_limit=8, final_limit=5)
SEARCH_SPANS = {"search.batch", "search.prepare", "search.upload",
                "search.encode", "search.funnel", "search.cascade",
                "search.int8", "search.bm25", "search.union"}


@pytest.fixture(scope="module")
def searcher():
    rng = np.random.default_rng(77)
    x = rng.standard_normal((N, D)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, size=(N, 12))
    rows = rng.choice(N, Q, replace=False)
    q = x[rows] + 0.05 * rng.standard_normal((Q, D)).astype(np.float32)
    texts = [" ".join(f"w{t}" for t in tokens[r][:6]) for r in rows]
    dense = DenseIndex(IndexConfig(dim=D, matryoshka_dims=(16, 32),
                                   initial_capacity=CAP), device="cpu")
    dense.insert(x)
    sparse = SparseIndex(SparseConfig(candidate_pool=32,
                                      max_postings_per_term=128),
                         analyzer=Analyzer(), device="cpu")
    sparse.analyzer.vocab = {f"w{t}": t for t in range(VOCAB)}
    sparse.add_pretokenized(tokens)
    return FusedSearcher(dense, sparse, FunnelConfig(**FUNNEL)), q, texts


def test_search_spans_and_results_with_tracing_on_and_off(searcher):
    fs, q, texts = searcher
    off = fs.search(q, texts, 5)
    before = METRICS.render()
    with TRACER.enable():
        on = fs.search(q, texts, 5)
        # the harness's traced path: prepare, then search_prepared
        split = fs.search_prepared(fs.prepare(q, texts), 5)
    for got in (on, split):
        assert torch.equal(got[0], off[0]) and torch.equal(got[1], off[1])
    spans = TRACER.session()
    assert set(_names(spans)) == SEARCH_SPANS
    by_batch = {}
    for s in spans:
        by_batch.setdefault(s.attrs["batch"], []).append(s.name)
    # every span of a batch carries its number; the split path has no
    # search.batch around it
    assert [set(v) for v in by_batch.values()] == [
        SEARCH_SPANS, SEARCH_SPANS - {"search.batch"}]
    parents = {s.seq: s.name for s in spans}
    for s in spans:
        want = {"search.prepare": "search.batch",
                "search.upload": "search.prepare",
                "search.encode": "search.prepare",
                "search.funnel": "search.batch",
                "search.cascade": "search.funnel",
                "search.int8": "search.funnel",
                "search.bm25": "search.funnel",
                "search.union": "search.funnel"}.get(s.name)
        if s.attrs["batch"] == min(by_batch) or s.name not in (
                "search.prepare", "search.funnel"):
            assert parents.get(s.parent) == want, s
    after = METRICS.render()
    assert 'stage_seconds_count{stage="search.bm25"} ' in after
    count = [line for line in after.splitlines()
             if line.startswith("search_batches_total")]
    was = [line for line in before.splitlines()
           if line.startswith("search_batches_total")]
    assert float(count[0].split()[1]) - float(
        (was or ["x 0"])[0].split()[1]) == 2


# ------------------------------------------------------------ the batcher

CFG = tdec.DecoderConfig(vocab_size=128, hidden=64, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=128, max_len=128,
                         dtype="float32")
BATCHER_SPANS = {"batcher.queue", "batcher.admit", "batcher.dispatch",
                 "batcher.readback", "batcher.deliver", "batcher.compact"}


@pytest.fixture(scope="module")
def params():
    return tdec.init_decoder_params(torch.Generator().manual_seed(5), CFG,
                                    "cpu")


def _serve(params, prefix, prompts, news):
    """Tokens of each request through one batcher, and its stats."""
    async def go():
        b = ContinuousBatcher(params, dataclasses.replace(CFG), slots=2,
                              prompt_pad=16, horizon=16, chunk=4)
        b.register_prefix(prefix)
        outs = await asyncio.gather(*[b.submit(p, max_new=n)
                                      for p, n in zip(prompts, news)])
        return outs, b.stats()

    return asyncio.run(go())


def test_batcher_spans_counters_and_tokens_with_tracing_on_and_off(params):
    rng = np.random.default_rng(9)
    prefix = [int(t) for t in rng.integers(1, 128, 5)]
    prompts = [prefix + [int(t) for t in rng.integers(1, 128, n)]
               for n in (3, 6, 2)] + [[int(t) for t in
                                        rng.integers(1, 128, 4)]]
    news = [10, 7, 12, 6]
    off, stats_off = _serve(params, prefix, prompts, news)
    with TRACER.enable():
        on, stats_on = _serve(params, prefix, prompts, news)
    assert on == off and stats_on == stats_off
    assert stats_on["admissions"] == 4 and stats_on["prefix_hits"] == 3
    assert stats_on["prefix_tokens"] == 3 * len(prefix)
    assert stats_on["compactions"] > 0

    spans = TRACER.session()
    assert set(_names(spans)) == BATCHER_SPANS
    assert all(s.end_ns is not None for s in spans)
    queue = {s.attrs["rid"]: s for s in spans if s.name == "batcher.queue"}
    admit = {s.attrs["rid"]: s for s in spans if s.name == "batcher.admit"}
    assert set(queue) == set(admit) == {0, 1, 2, 3}
    for rid, a in admit.items():
        # the wait ends where the admission starts
        assert queue[rid].end_ns <= a.start_ns
        hit = rid < 3
        assert a.attrs["prefix_hit"] is hit
        assert a.attrs["suffix_tokens"] == len(prompts[rid]) - (
            len(prefix) if hit else 0)
    chunks = {name: sorted(s.attrs["chunk"] for s in spans
                           if s.name == name)
              for name in ("batcher.dispatch", "batcher.readback",
                           "batcher.deliver")}
    dispatch = [s for s in spans if s.name == "batcher.dispatch"]
    assert chunks["batcher.dispatch"] == list(range(len(dispatch)))
    # the last chunks (up to the lookahead's 2 and one being dispatched)
    # may still be in flight when the last request is answered and the
    # loop is cancelled; every chunk delivered was read back, in order
    n = len(chunks["batcher.deliver"])
    assert n >= len(dispatch) - 3
    assert chunks["batcher.deliver"] == list(range(n))
    assert set(chunks["batcher.deliver"]) <= set(chunks["batcher.readback"])
    assert all(1 <= s.attrs["rows"] <= 2 for s in dispatch)
    # admissions run in executor threads, deliveries on the loop
    deliver = [s for s in spans if s.name == "batcher.deliver"]
    assert {s.tid for s in deliver}.isdisjoint({s.tid for s in dispatch})
    text = METRICS.render()
    for name in ("decode_admissions_total", "decode_prefix_hits_total",
                 "decode_prefix_tokens_total"):
        assert name in text
