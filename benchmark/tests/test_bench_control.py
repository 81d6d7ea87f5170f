"""`correct` can come out false. At sizes the CPU holds: sound runs of
each cell read correct; the control (the reference one precision step
below the configuration's, in the program's place) reads not correct;
and a run with its timed path broken underneath reads not correct, for
each fault the cell can have: an answer or a token altered where it is
produced, half of the batch left out. On the card, at the cells' own
sizes, the same readings come from benchmark/control.py."""

import time

import pytest
import torch

from benchmark import harness

from .conftest import SEED, tiny_generate, tiny_search

CPU = torch.device("cpu")
SEARCH = ("hybrid-1m768.mixed-8192", "hybrid-1m768.vectors-8192")


def _run(cell, fault=None):
    out, _ = harness.driver_for(cell).run(cell, SEED, 0.5, False, CPU,
                                          time.perf_counter(), fault=fault)
    return out


@pytest.mark.parametrize("name", SEARCH)
def test_sound_search_runs_read_correct(name):
    out = _run(tiny_search(name))
    assert out.correct and out.failed == 0 and out.attempted > 0
    assert all(v <= lim for _, v, lim in out.checks)
    assert len(out.checks) == (3 if "mixed" in name else 1)


@pytest.mark.parametrize("name", SEARCH)
def test_search_control_reads_not_correct(name):
    cell = tiny_search(name)
    checks = harness.driver_for(cell).control_checks(cell, SEED, CPU)
    assert any(v > lim for _, v, lim in checks), checks
    # each number reads the control worse than a sound run (at the cell's
    # own size each one fails on its own: PERF.md gives the readings)
    sound = {n: v for n, v, _ in _run(cell).checks}
    assert all(v > sound[n] for n, v, _ in checks), (checks, sound)


def _alter_answers(searcher):
    orig = searcher.search_prepared

    def altered(*a, **k):
        scores, ids = orig(*a, **k)
        return scores, (ids + 1) % searcher.dense.size

    searcher.search_prepared = altered


def _half_batch(searcher):
    """Only the first half of each batch is searched; the other half gets
    the first half's answers."""
    orig = searcher.search

    def half(q, texts, k, **kw):
        n = len(q) // 2
        scores, ids = orig(q[:n], None if texts is None else texts[:n], k,
                           **kw)
        return torch.cat([scores, scores]), torch.cat([ids, ids])

    searcher.search = half


def _short_batch(searcher):
    """Half of each batch is left out of the answer."""
    orig = searcher.search

    def short(q, texts, k, **kw):
        scores, ids = orig(q, texts, k, **kw)
        return scores[: len(q) // 2], ids[: len(q) // 2]

    searcher.search = short


@pytest.mark.parametrize("fault", [_alter_answers, _half_batch,
                                   _short_batch])
@pytest.mark.parametrize("name", SEARCH)
def test_broken_search_reads_not_correct(name, fault):
    out = _run(tiny_search(name), fault)
    assert not out.correct, out.checks


def test_altered_bm25_scores_read_not_correct(monkeypatch):
    from rag_application_tpu_torch.ops import bm25

    orig = bm25.bm25_match_rows
    monkeypatch.setattr(bm25, "bm25_match_rows",
                        lambda *a: orig(*a) * 1.01)
    out = _run(tiny_search("hybrid-1m768.mixed-8192"))
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["bm25_score_err"] > 1e-3


def _no_query_terms(searcher):
    """The BM25 query encode marks every query term invalid: the sparse
    branch answers every query with no hit."""
    orig = searcher.sparse.encode_queries

    def empty(texts):
        rows, terms, valid = orig(texts)
        return rows, terms, torch.zeros_like(valid)

    searcher.sparse.encode_queries = empty


def _other_candidates(monkeypatch):
    """The candidate stage hands the exact rescore the neighbours of its
    candidates: every hit's score is exact, the hits are the wrong ones."""
    from rag_application_tpu_torch.ops import bm25

    orig = bm25.bm25_candidates

    def shifted(post_docs, post_weights, n_docs, *a):
        cand = orig(post_docs, post_weights, n_docs, *a)
        return torch.where(cand < n_docs, (cand + 1) % n_docs, cand)

    monkeypatch.setattr(bm25, "bm25_candidates", shifted)


@pytest.mark.parametrize("where", ["encode", "candidates"])
def test_wrong_bm25_hits_read_not_correct(monkeypatch, where):
    fault = None
    if where == "encode":
        fault = _no_query_terms
    else:
        _other_candidates(monkeypatch)
    out = _run(tiny_search("hybrid-1m768.mixed-8192"), fault)
    got = {n: (v, lim) for n, v, lim in out.checks}
    assert not out.correct
    # the scores of the hits returned are exact: the top-k check fails
    assert got["bm25_score_err"][0] <= got["bm25_score_err"][1]
    assert got["bm25_topk_miss"][0] > got["bm25_topk_miss"][1]


def test_generation_sound_and_control():
    cell = tiny_generate()
    out = _run(cell)
    assert out.correct and out.failed == 0 and out.judged
    limit = cell.mix["limits"]["served_logit_gap"]
    control = harness.driver_for(cell).judge(cell.config, SEED, out.judged,
                                             CPU, bits=4)
    assert control > limit > out.checks[0][1]


def test_generation_with_altered_tokens_reads_not_correct(monkeypatch):
    from rag_application_tpu_torch.llm import scheduler

    orig = scheduler.sample_logits
    vocab = tiny_generate().config["vocab_size"]

    def altered(*a, **k):
        return (orig(*a, **k) + 1) % vocab

    monkeypatch.setattr(scheduler, "sample_logits", altered)
    out = _run(tiny_generate())
    assert not out.correct
