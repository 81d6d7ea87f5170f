"""The whole slice: the port's `FusedSearcher.search` against the JAX
reference's on the same corpus, on the CPU.

Both packages search identical tables (the port's are carried over with
`state.py`); the JAX funnel runs its Pallas scan in interpret mode, as
tests/test_fused.py does. Ids must be equal; scores agree to float32
rounding (rtol 1e-5: the exact rescore sums in another order).
"""

import numpy as np
import pytest
import torch

from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.index.analyzer import Analyzer as JAnalyzer
from rag_application_tpu.index.dense import DenseIndex as JDenseIndex
from rag_application_tpu.index.sparse import SparseIndex as JSparseIndex
from rag_application_tpu.search.fused import FusedSearcher as JFusedSearcher
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import SparseConfig
from rag_application_tpu_torch.index.analyzer import Analyzer
from rag_application_tpu_torch.index.dense import DenseIndex
from rag_application_tpu_torch.index.sparse import SparseIndex
from rag_application_tpu_torch.ops import INVALID_ID
from rag_application_tpu_torch.search.fused import FusedSearcher
from rag_application_tpu_torch.utils import METRICS

N, D, CAP, VOCAB, Q = 450, 64, 512, 600, 6
MODES = {
    "bf16+int8": dict(),
    "int8_capacity": dict(store_bf16=False),
    "bf16_only": dict(store_int8=False),
}
FUNNEL = dict(matryoshka_limits=(24, 16), dense_limit=12, quantized_limit=16,
              sparse_limit=8, final_limit=5)


def _corpus():
    rng = np.random.default_rng(1234)
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
    """(JAX dense, JAX sparse, port dense, port sparse, inputs) per
    storage mode; the port's tables are the reference's, carried over."""
    x, tokens, q, texts, fmask = _corpus()
    kw = dict(dim=D, matryoshka_dims=(16, 32), initial_capacity=CAP,
              **MODES[request.param])
    jd = JDenseIndex(JIndexConfig(**kw))
    jd.insert(x)
    jd.delete(np.array([17, 200]))
    js = JSparseIndex(JSparseConfig(candidate_pool=32,
                                    max_postings_per_term=128),
                      analyzer=JAnalyzer())
    vocab = {f"w{t}": t for t in range(VOCAB)}
    js.analyzer.vocab = dict(vocab)
    js.add_pretokenized(tokens)
    js.rebuild()
    td = state.dense_from_numpy(IndexConfig(**kw), _dense_arrays(jd),
                                jd.size, jd.has_deletes, device="cpu")
    ts = state.sparse_from_numpy(
        SparseConfig(candidate_pool=32, max_postings_per_term=128),
        _sparse_arrays(js), vocab, device="cpu")
    return request.param, jd, js, td, ts, (q, texts, fmask)


def _compare(j_out, t_out):
    js, ji = (np.asarray(a) for a in j_out)
    ts, ti = t_out[0].numpy(), t_out[1].numpy()
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    assert ts.shape == ti.shape == js.shape
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    ok = np.isfinite(js)
    np.testing.assert_allclose(ts[ok], js[ok], rtol=1e-5, atol=1e-7)
    assert (ti[~ok] == INVALID_ID).all()


@pytest.mark.parametrize("fusion", ["dense", "rrf", "dbsf"])
@pytest.mark.parametrize("filtered", [False, True])
def test_search_matches_reference(pair, fusion, filtered):
    mode, jd, js, td, ts, (q, texts, fmask) = pair
    fm = fmask if filtered else None
    j = JFusedSearcher(jd, js, JFunnelConfig(final_fusion=fusion, **FUNNEL),
                       scan_impl="pallas", scan_block_rows=128)
    t = FusedSearcher(td, ts, FunnelConfig(final_fusion=fusion, **FUNNEL),
                      scan_impl="pallas", scan_block_rows=128)
    j_out = j.search(q, texts, 5, filter_mask=fm)
    t_out = t.search(q, texts, 5, filter_mask=fm)
    _compare(j_out, t_out)
    ids = t_out[1].numpy()
    if filtered:
        assert fmask[ids[ids != INVALID_ID]].all()
    assert not np.isin(ids, [17, 200]).any()  # deleted rows never surface


def test_blocked_engine_and_cascade_off(pair):
    """scan_impl="xla" maps to blocked_topk in both packages; the
    bench's serving setting runs without the matryoshka cascade."""
    mode, jd, js, td, ts, (q, texts, fmask) = pair
    for impl, matryoshka in (("xla", True), ("pallas", False)):
        j = JFusedSearcher(jd, js, JFunnelConfig(**FUNNEL), scan_impl=impl)
        t = FusedSearcher(td, ts, FunnelConfig(**FUNNEL), scan_impl=impl)
        _compare(j.search(q, texts, 5, use_matryoshka=matryoshka),
                 t.search(q, texts, 5, use_matryoshka=matryoshka))
        # vectors only (no sparse leg)
        if mode == "bf16_only" and not matryoshka:
            # no branch left: both refuse
            for s in (j, t):
                with pytest.raises(ValueError, match="no funnel branch"):
                    s.search(q, None, 5, use_matryoshka=False)
            continue
        _compare(j.search(q, None, 5, use_matryoshka=matryoshka),
                 t.search(q, None, 5, use_matryoshka=matryoshka))


def test_own_insert_end_to_end():
    """The port building its own tables from the raw vectors (no carried
    state) returns the reference's ids, and self-retrieves."""
    x, tokens, q, texts, _ = _corpus()
    kw = dict(dim=D, matryoshka_dims=(16, 32), initial_capacity=CAP)
    jd = JDenseIndex(JIndexConfig(**kw))
    td = DenseIndex(IndexConfig(**kw), device="cpu")
    js = JSparseIndex(JSparseConfig(candidate_pool=32,
                                    max_postings_per_term=128),
                      analyzer=JAnalyzer())
    ts = SparseIndex(SparseConfig(candidate_pool=32,
                                  max_postings_per_term=128),
                     analyzer=Analyzer(), device="cpu")
    for d_, s_ in ((jd, js), (td, ts)):
        d_.insert(x)
        s_.analyzer.vocab = {f"w{t}": t for t in range(VOCAB)}
        s_.add_pretokenized(tokens)
    j = JFusedSearcher(jd, js, JFunnelConfig(**FUNNEL), scan_impl="pallas",
                       scan_block_rows=128)
    t = FusedSearcher(td, ts, FunnelConfig(**FUNNEL), scan_block_rows=128)
    assert t._resolved_engine()[0] == "xla"  # "auto" on a CPU index
    before = METRICS.render()
    j_out = j.search(q, texts, 5)
    t_out = t.search(q, texts, 5)
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]),
                               rtol=1e-4)
    assert METRICS.render() != before  # search_queries counted


def test_entry_points_default_to_cuda():
    """With no device named the port runs on CUDA, and raises where
    there is none; it never falls back to the CPU silently."""
    if torch.cuda.is_available():
        assert DenseIndex(IndexConfig(dim=128)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseIndex(IndexConfig(dim=128))
    with pytest.raises(RuntimeError, match="CUDA"):
        SparseIndex(SparseConfig(), analyzer=Analyzer())
