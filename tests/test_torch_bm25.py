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
