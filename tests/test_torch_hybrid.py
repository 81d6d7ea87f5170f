"""The staged hybrid funnel (`search/hybrid.py`: `hybrid_search`,
`HybridSearcher`) against the JAX reference's, on the CPU.

Both packages search identical tables (the port's carried over with
`state.py`); the BM25 leg runs the match kernel's plain version in the
port and the Pallas kernel in interpret mode in the reference. Ids must
be equal; scores agree to float32 rounding (rtol 1e-5: the exact
rescore sums in another order), as in tests/test_torch_fused.py.
"""

import numpy as np
import pytest

from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.index.analyzer import Analyzer as JAnalyzer
from rag_application_tpu.index.dense import DenseIndex as JDenseIndex
from rag_application_tpu.index.sparse import SparseIndex as JSparseIndex
from rag_application_tpu.search.hybrid import HybridSearcher as JHybrid
from rag_application_tpu.search.hybrid import hybrid_search as j_hybrid
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import SparseConfig
from rag_application_tpu_torch.index.analyzer import Analyzer
from rag_application_tpu_torch.index.dense import DenseIndex
from rag_application_tpu_torch.index.sparse import SparseIndex
from rag_application_tpu_torch.ops import INVALID_ID
from rag_application_tpu_torch.search import HybridSearcher, hybrid_search

N, D, CAP, VOCAB, Q = 300, 64, 512, 500, 6
MODES = {
    "bf16+int8": dict(),
    "int8_capacity": dict(store_bf16=False),
    "bf16_only": dict(store_int8=False),
}
FUNNEL = dict(matryoshka_limits=(24, 16), dense_limit=12, quantized_limit=16,
              sparse_limit=8, final_limit=5)
SPARSE = dict(candidate_pool=32, max_postings_per_term=128)


def _corpus():
    rng = np.random.default_rng(4321)
    x = (rng.standard_normal((N, D))
         * np.exp(-0.03 * np.arange(D))).astype(np.float32)
    ranks = np.arange(1, VOCAB + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    tokens = rng.choice(VOCAB, size=(N, 16), p=p)
    rows = rng.choice(N, Q, replace=False)
    q = x[rows] + 0.05 * rng.standard_normal((Q, D)).astype(np.float32)
    texts = [" ".join(f"w{t}" for t in tokens[r][:8]) for r in rows]
    fmask = rng.random(CAP) > 0.3
    return x, tokens, q, texts, fmask


def _dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": (np.asarray(j.vecs).view(np.uint16)
                     if j.vecs is not None else None),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def _sparse_arrays(j):
    dv = j.device_arrays()
    terms, tfs, counts, lens = j._flat()
    return {"post_docs": np.asarray(dv["post_docs"]), "post_weights": None,
            "doc_packed": np.asarray(dv["doc_packed"]), "v_pad": dv["v_pad"],
            "terms": terms, "tfs": tfs, "counts": counts, "lens": lens,
            "deleted": np.array(sorted(j._deleted), dtype=np.int64)}


@pytest.fixture(scope="module", params=list(MODES))
def pair(request):
    """(mode, JAX dense, JAX sparse, port dense, port sparse, inputs);
    the port's tables are the reference's, carried over."""
    x, tokens, q, texts, fmask = _corpus()
    kw = dict(dim=D, matryoshka_dims=(16, 32), initial_capacity=CAP,
              **MODES[request.param])
    jd = JDenseIndex(JIndexConfig(**kw))
    jd.insert(x)
    jd.delete(np.array([11, 150]))
    js = JSparseIndex(JSparseConfig(**SPARSE), analyzer=JAnalyzer())
    vocab = {f"w{t}": t for t in range(VOCAB)}
    js.analyzer.vocab = dict(vocab)
    js.add_pretokenized(tokens)
    js.delete(11)
    js.delete(150)
    js.rebuild()
    td = state.dense_from_numpy(IndexConfig(**kw), _dense_arrays(jd),
                                jd.size, jd.has_deletes, device="cpu")
    ts = state.sparse_from_numpy(SparseConfig(**SPARSE), _sparse_arrays(js),
                                 vocab, device="cpu")
    return request.param, jd, js, td, ts, (q, texts, fmask)


def _compare(j_res, t_res):
    assert t_res.scores.dtype == np.float32 and t_res.rows.dtype == np.int32
    np.testing.assert_array_equal(t_res.rows, j_res.rows)
    np.testing.assert_array_equal(t_res.valid, j_res.valid)
    ok = j_res.valid
    np.testing.assert_allclose(t_res.scores[ok], j_res.scores[ok],
                               rtol=1e-5, atol=1e-7)
    assert (t_res.rows[~ok] == INVALID_ID).all()
    assert np.isneginf(t_res.scores[~ok]).all()


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("cascade", [False, True])
@pytest.mark.parametrize("with_text", [False, True])
def test_hybrid_search_matches_reference(pair, filtered, cascade, with_text):
    mode, jd, js, td, ts, (q, texts, fmask) = pair
    fm = fmask if filtered else None
    qt = texts if with_text else None
    kw = dict(funnel=None, filter_mask=fm, use_matryoshka=cascade)
    jf, tf = JFunnelConfig(**FUNNEL), FunnelConfig(**FUNNEL)
    if mode == "bf16_only" or (cascade and mode == "int8_capacity"):
        # the staged path always runs the int8 leg, and the cascade needs
        # the bf16 plane: both packages refuse
        with pytest.raises(ValueError):
            j_hybrid(jd, js, q, qt, 5, **dict(kw, funnel=jf))
        with pytest.raises(ValueError):
            hybrid_search(td, ts, q, qt, 5, **dict(kw, funnel=tf))
        return
    j_res = j_hybrid(jd, js, q, qt, 5, **dict(kw, funnel=jf))
    t_res = hybrid_search(td, ts, q, qt, 5, **dict(kw, funnel=tf))
    _compare(j_res, t_res)
    rows = t_res.rows[t_res.valid]
    if filtered:
        assert fmask[rows].all()
    assert not np.isin(rows, [11, 150]).any()  # deleted rows never surface


def test_hybrid_without_sparse_and_default_k(pair):
    mode, jd, js, td, ts, (q, texts, _) = pair
    jh = JHybrid(jd, None, JFunnelConfig(**FUNNEL))
    th = HybridSearcher(td, None, FunnelConfig(**FUNNEL))
    if mode == "bf16_only":
        # no int8 plane: the staged path's int8 leg refuses in both
        with pytest.raises(ValueError, match="store_int8=False"):
            jh.search(q, texts, use_matryoshka=False)
        with pytest.raises(ValueError, match="store_int8=False"):
            th.search(q, texts, use_matryoshka=False)
        return
    j_res = jh.search(q, texts, use_matryoshka=False)
    t_res = th.search(q, texts, use_matryoshka=False)
    _compare(j_res, t_res)
    assert t_res.rows.shape == (Q, 10)
    # k=None: the funnel's final_limit
    _compare(j_hybrid(jd, js, q, texts, None, funnel=JFunnelConfig(**FUNNEL),
                      use_matryoshka=False),
             hybrid_search(td, ts, q, texts, None,
                           funnel=FunnelConfig(**FUNNEL),
                           use_matryoshka=False))


def test_searcher_own_inserts_and_deletes():
    """`HybridSearcher.add/delete/search` on the port's own inserts: self
    retrieval as tests/test_hybrid.py checks it, in both packages."""
    x, tokens, _, _, _ = _corpus()
    texts = [" ".join(f"w{t}" for t in row) for row in tokens[:40]]
    kw = dict(dim=D, matryoshka_dims=(16, 32), initial_capacity=16)
    out = []
    for cls, dense, sparse, funnel, extra in (
            (JHybrid, JDenseIndex(JIndexConfig(**kw)),
             JSparseIndex(JSparseConfig(**SPARSE), analyzer=JAnalyzer()),
             JFunnelConfig(**FUNNEL), {}),
            (HybridSearcher, DenseIndex(IndexConfig(**kw), device="cpu"),
             SparseIndex(SparseConfig(**SPARSE), analyzer=Analyzer(),
                         device="cpu"), FunnelConfig(**FUNNEL), {})):
        s = cls(dense, sparse, funnel=funnel)
        np.testing.assert_array_equal(s.add(x[:40], texts), np.arange(40))
        s.delete([3, 4])
        assert len(s) == 40
        noisy = x[:40] + 0.01 * np.random.default_rng(2).standard_normal(
            (40, D)).astype(np.float32)
        res = s.search(noisy, texts, k=3, **extra)
        keep = np.setdiff1d(np.arange(40), [3, 4])
        assert (res.rows[keep, 0] == keep).all()
        assert not np.isin(res.rows[res.valid], [3, 4]).any()
        out.append(res)
    np.testing.assert_array_equal(out[1].rows, out[0].rows)
