"""Parity of the port's BM25 ops (`ops.bm25`) with the JAX reference,
the match kernel run as the Pallas kernel in interpret mode, on the CPU.

Tolerances: BM25 scores agree to float32 rounding (rtol 1e-6). The
port adds the L slots in order; inside the jitted `bm25_topk` XLA fuses
the sum in an order that depends on where the hits sit in the row, so
two docs with the same terms can score one ulp apart there. Ids are
therefore equal except between such near-tied docs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.index.analyzer import Analyzer as JAnalyzer
from rag_application_tpu.index.sparse import SparseIndex as JSparseIndex
from rag_application_tpu.ops import bm25 as jb
from rag_application_tpu_torch.ops import bm25 as tb


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_ids_match(t_ids, j_ids, t_scores, j_scores, rtol=1e-6):
    """Ids equal, except that near-tied entries (scores within rtol) may
    swap places or trade places at the k cutoff."""
    np.testing.assert_allclose(t_scores, j_scores, rtol=rtol)
    for q in range(t_ids.shape[0]):
        for p in np.nonzero(t_ids[q] != j_ids[q])[0]:
            s = t_scores[q, p]
            tol = rtol * max(abs(s), 1e-30)
            near = np.abs(j_scores[q] - s) <= tol
            assert t_ids[q, p] in j_ids[q][near] or \
                abs(j_scores[q, -1] - s) <= tol, (q, p)


def test_match_scores_plain_matches_pallas(rng):
    q, pool, l, t = 6, 16, 32, 8
    dt = rng.integers(-1, 40, (q, pool, l)).astype(np.int32)
    dw = rng.random((q, pool, l)).astype(np.float32)
    qt = rng.integers(0, 40, (q, t)).astype(np.int32)
    qv = rng.random((q, t)) > 0.3
    j = np.asarray(jb.bm25_match_scores(*(jnp.asarray(a) for a in
                                          (dt, dw, qt, qv))))
    out = tb.bm25_match_scores(_t(dt), _t(dw), _t(qt), _t(qv)).numpy()
    assert out.shape == (q, pool) and out.dtype == np.float32
    np.testing.assert_allclose(out, j, rtol=1e-6)
    # strided views of interleaved rows give the same scores
    packed = np.concatenate([dt, dw.view(np.int32)], axis=-1)
    tp = _t(packed)
    out2 = tb.bm25_match_scores(tp[..., :l], tp[..., l:].view(torch.float32),
                                _t(qt), _t(qv)).numpy()
    np.testing.assert_array_equal(out2, out)


def test_impact_weights_dedup_and_pack(rng):
    tf_ = rng.integers(1, 6, 50).astype(np.int32)
    dl = rng.integers(5, 40, 50).astype(np.int32)
    idf = rng.random(50).astype(np.float32) * 3
    j = np.asarray(jb.bm25_impact_weights(jnp.asarray(tf_), jnp.asarray(dl),
                                          jnp.asarray(idf), avgdl=17.0))
    t = tb.bm25_impact_weights(_t(tf_), _t(dl), _t(idf), avgdl=17.0).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)

    cand = rng.integers(0, 30, (4, 25)).astype(np.int32)
    np.testing.assert_array_equal(
        tb._dedup_sorted(_t(cand), 99).numpy(),
        np.asarray(jb._dedup_sorted(jnp.asarray(cand), 99)))

    terms = rng.integers(-1, 100, (7, 4)).astype(np.int32)
    w = rng.random((7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tb.pack_doc_major(_t(terms), _t(w)).numpy(),
        np.asarray(jb.pack_doc_major(jnp.asarray(terms), jnp.asarray(w))))


def _docs(rng, n, vocab=300, length=20):
    ranks = np.arange(1, vocab + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return rng.choice(vocab, size=(n, length), p=p)


def _reference_index(tokens, vocab=300, **cfg):
    sp = JSparseIndex(JSparseConfig(**cfg), analyzer=JAnalyzer())
    sp.analyzer.vocab = {f"w{t}": t for t in range(vocab)}
    sp.add_pretokenized(tokens)
    sp.rebuild()
    return sp


def _two_array_layout(sp, tokens):
    """The reference's two-array postings (used beyond 2^21 docs), built
    from the same impact order as its packed layout: ids and f16 weights."""
    dv = sp.device_arrays()
    packed = np.asarray(dv["post_docs"])
    n = tokens.shape[0]
    docs = np.where(packed == n, n, packed & ((1 << 21) - 1)).astype(np.int32)
    w = np.where(packed == n, 0, packed >> 21).astype(np.float16) / 1019.0
    return docs, w


@pytest.mark.parametrize("layout", ["packed", "two_array"])
@pytest.mark.parametrize("filtered", [False, True])
def test_bm25_topk_matches_reference(rng, layout, filtered):
    tokens = _docs(rng, 800)
    sp = _reference_index(tokens, candidate_pool=32,
                          max_postings_per_term=128)
    dv = sp.device_arrays()
    texts = [" ".join(f"w{t}" for t in tokens[i][:6]) for i in range(0, 800, 53)]
    q_rows, q_terms, q_valid = sp.encode_queries(texts)
    if layout == "packed":
        post_docs, post_w = np.asarray(dv["post_docs"]), None
    else:
        post_docs, post_w = _two_array_layout(sp, tokens)
    fm = rng.random(800) > 0.4 if filtered else None
    jargs = (jnp.asarray(post_docs),
             jnp.asarray(post_w) if post_w is not None else None,
             dv["doc_packed"], q_rows, q_terms, q_valid)
    js, ji = jb.bm25_topk(*jargs, 10, pool=32,
                          filter_mask=jnp.asarray(fm) if filtered else None)
    targs = [_t(post_docs), _t(post_w) if post_w is not None else None]
    targs += [_t(np.asarray(a)) for a in jargs[2:]]
    ts, ti = tb.bm25_topk(*targs, 10, pool=32,
                          filter_mask=_t(fm) if filtered else None)
    assert_ids_match(ti.numpy(), np.asarray(ji), ts.numpy(), np.asarray(js))
    assert (ti.numpy() == np.asarray(ji)).mean() > 0.95
    assert np.isfinite(ts.numpy()).any()
    if filtered:
        hit = ti.numpy()[np.isfinite(ts.numpy())]
        assert fm[hit].all()


def _real_candidates(rng, pool):
    """Stage-1 candidates of the test corpus at ``pool`` (duplicates
    already padded to the sentinel id N), plus one row of sentinels only,
    and the queries' (Q, T) terms with invalid slots (short queries and
    one with no known term)."""
    tokens = _docs(rng, 800)
    sp = _reference_index(tokens, candidate_pool=pool,
                          max_postings_per_term=128)
    dv = sp.device_arrays()
    texts = [" ".join(f"w{t}" for t in tokens[i][:1 + i % 9])
             for i in range(0, 800, 37)] + ["zzz qqq"]
    q_rows, q_terms, q_valid = (_t(np.asarray(a))
                                for a in sp.encode_queries(texts))
    doc_packed = _t(np.asarray(dv["doc_packed"]))
    n = doc_packed.shape[0] - 1
    cand = tb.bm25_candidates(_t(np.asarray(dv["post_docs"])), None, n,
                              q_rows, q_valid, pool)
    cand = torch.cat([cand, torch.full((1, cand.shape[1]), n,
                                       dtype=cand.dtype)])
    q_terms = torch.cat([q_terms, q_terms[:1]])
    q_valid = torch.cat([q_valid, q_valid[:1]])
    return doc_packed, cand, q_terms, q_valid


@pytest.mark.parametrize("pool", [24, 32])
def test_match_rows_plain_matches_pallas_on_real_candidates(rng, pool):
    """`bm25_match_rows_plain` (and its wrapper on CPU tensors) against
    the reference's stage 2: the gather of the packed rows, then the
    Pallas match kernel in interpret mode. Pool 24 does not divide the
    kernel's 128-row blocks. Within 1 f32 ulp: XLA sums the L slots in
    its own order."""
    doc_packed, cand, q_terms, q_valid = _real_candidates(rng, pool)
    n = doc_packed.shape[0] - 1
    assert cand.shape[1] == pool and cand.dtype == torch.int32
    assert bool((cand[:-1] == n).any()) and bool((cand[-1] == n).all())
    assert not bool(q_valid.all()) and not bool(q_valid[-2].any())
    out = tb.bm25_match_rows_plain(doc_packed, cand, q_terms, q_valid)
    assert torch.equal(tb.bm25_match_rows(doc_packed, cand, q_terms,
                                          q_valid), out)
    l = doc_packed.shape[1] // 2
    packed = doc_packed.numpy()[cand.numpy()]
    ref = np.asarray(jb.bm25_match_scores(
        jnp.asarray(packed[..., :l]),
        jnp.asarray(packed[..., l:].view(np.float32)),
        jnp.asarray(q_terms.numpy()), jnp.asarray(q_valid.numpy())))
    np.testing.assert_array_max_ulp(out.numpy(), ref, maxulp=1)
    assert (out.numpy() > 0).mean() > 0.3
    assert not out[-1].any() and not out[-2].any()


def test_bm25_topk_stage2_goes_through_match_rows(rng, monkeypatch):
    """`bm25_topk` rescores through `bm25_match_rows` on the table and the
    candidate ids, never through the gathered-rows entry, and its ids
    stay the reference's at a pool that does not divide 128."""
    calls = []
    match_rows = tb.bm25_match_rows

    def counting(*args):
        calls.append(tuple(a.shape for a in args))
        return match_rows(*args)

    def refuse(*args):
        raise AssertionError("bm25_topk reached bm25_match_scores")

    monkeypatch.setattr(tb, "bm25_match_rows", counting)
    monkeypatch.setattr(tb, "bm25_match_scores", refuse)
    tokens = _docs(rng, 800)
    sp = _reference_index(tokens, candidate_pool=24,
                          max_postings_per_term=128)
    dv = sp.device_arrays()
    texts = [" ".join(f"w{t}" for t in tokens[i][:2 + i % 7])
             for i in range(0, 800, 41)]
    q_rows, q_terms, q_valid = sp.encode_queries(texts)
    js, ji = jb.bm25_topk(dv["post_docs"], None, dv["doc_packed"], q_rows,
                          q_terms, q_valid, 10, pool=24)
    targs = [_t(np.asarray(a)) for a in (dv["post_docs"],)] + [None] + [
        _t(np.asarray(a)) for a in (dv["doc_packed"], q_rows, q_terms,
                                    q_valid)]
    ts, ti = tb.bm25_topk(*targs, 10, pool=24)
    assert calls == [(tuple(dv["doc_packed"].shape), (len(texts), 24),
                      tuple(q_terms.shape), tuple(q_valid.shape))]
    assert_ids_match(ti.numpy(), np.asarray(ji), ts.numpy(), np.asarray(js))
    assert (ti.numpy() == np.asarray(ji)).mean() > 0.95


def _sorted_search_hits(q_terms, q_valid, doc_terms):
    """The CUDA kernel's membership test, step for step: each valid query
    term ranked by counting (term, slot) into a sorted array, padded with
    the largest to a power of two P >= T, then a binary search of log2 P
    steps for each doc term."""
    t = len(q_terms)
    p = 1
    while p < t:
        p *= 2
    nv = int(sum(bool(v) for v in q_valid))
    s = [0] * p
    for j in range(t):
        if not q_valid[j]:
            continue
        rank = sum(bool(q_valid[k]) and (q_terms[k] < q_terms[j] or (
            q_terms[k] == q_terms[j] and k < j)) for k in range(t))
        s[rank] = q_terms[j]
        if rank == nv - 1:
            s[nv:] = [q_terms[j]] * (p - nv)
    hits = []
    for x in doc_terms:
        i, h, steps = 0, p >> 1, 0
        while h > 0:
            i |= h if s[i | h] <= x else 0
            h >>= 1
            steps += 1
        assert steps == max(0, (t - 1).bit_length())  # ceil(log2 T)
        hits.append(nv > 0 and s[i] == x)
    return hits


@pytest.mark.parametrize("t", [1, 2, 5, 8, 32, 40])
def test_sorted_search_is_exact_membership(rng, t):
    """The kernel's sorted binary search finds exactly the valid query
    terms: duplicates, invalid slots (never matched, whatever term they
    hold), the doc pad term -1 and the query pad term -2."""
    for _ in range(40):
        qt = rng.integers(-2, 12, t)
        qv = rng.random(t) > 0.3
        dt = rng.integers(-2, 14, 32)
        want = [bool(((qt == x) & qv).any()) for x in dt]
        assert _sorted_search_hits(list(qt), list(qv), list(dt)) == want


def test_match_rows_no_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.bm25_match_rows(torch.empty((9, 8), dtype=torch.int32, **meta),
                           torch.empty((2, 3), dtype=torch.int32, **meta),
                           torch.empty((2, 4), dtype=torch.int32, **meta),
                           torch.empty((2, 4), dtype=torch.bool, **meta))
