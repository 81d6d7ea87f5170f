"""The write path and the tokens wire: the port's `Embedder`, `Collection`
and `VectorStore` against the JAX reference's, on the CPU.

Mirrors tests/test_store.py. Both packages embed with the same weights
(the flax encoder carried over by `state.encoder_params_from_jax`, f32
config, so vectors agree to atol 1e-5) and store the same embeddings.
The port inserts through its own prep pass, so its dense tables may sit a
rounding step from the reference's (insert parity is checked apart, at
tests/test_torch_prep.py's bounds); the search-equality tests then carry
the reference's dense tables over with `state.dense_from_numpy`, as the
funnel tests do. Rows must be equal; scores agree to rtol 1e-5.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.search.rerank import \
    LateInteractionReranker as JReranker
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu.store.collection import VectorStore as JVectorStore
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, EncoderConfig
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import SparseConfig
from rag_application_tpu_torch.models.cache import EmbeddingCache
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.encoder import init_encoder
from rag_application_tpu_torch.search.rerank import LateInteractionReranker
from rag_application_tpu_torch.store.collection import Collection
from rag_application_tpu_torch.store.collection import VectorStore

ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=16, out_dim=32, dtype="float32")
TEXTS = [f"chunk number {i} about topic{i} and subject{i % 3}"
         for i in range(10)]
CHAT = ["hello there", "general kenobi"]


def small_config(cls, index, sparse, funnel):
    cfg = cls()
    cfg.index = index(dim=32, matryoshka_dims=(8, 16), initial_capacity=8)
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    return cfg


J_CFG = functools.partial(small_config, JConfig, JIndexConfig,
                          JSparseConfig, JFunnelConfig)
T_CFG = functools.partial(small_config, Config, IndexConfig, SparseConfig,
                          FunnelConfig)


@functools.lru_cache(maxsize=None)
def embedders():
    """(JAX Embedder, port Embedder) on the same encoder weights."""
    js = j_init(JEncoderConfig(**ECFG), max_len=16, seed=11)
    cfg = EncoderConfig(**ECFG)
    ts = init_encoder(cfg, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return (JEmbedder(js, batch_size=4, max_len=16),
            Embedder(ts, batch_size=4, max_len=16))


def dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": (np.asarray(j.vecs).view(np.uint16)
                     if j.vecs is not None else None),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def fill(col):
    """test_store.py's collection: doc-1 rows 0-4, doc-2 rows 5-9 (with a
    user_id), then two chat messages of thread-9."""
    embs = embedders()[0].encode(TEXTS + CHAT)
    chunks = [{"text": t, "page": i} for i, t in enumerate(TEXTS)]
    col.store_document_vectors("doc-1", chunks[:5], embs[:5])
    col.store_document_vectors("doc-2", chunks[5:], embs[5:10],
                               extra_payload={"user_id": "u2"})
    col.store_chat_vectors("thread-9", [{"text": t} for t in CHAT],
                           embs[10:])
    return embs


def make_pair():
    """(JAX Collection, port Collection, embeddings). The port's dense
    tables are checked against the reference's, then replaced by them."""
    jcol = JCollection("user_test", J_CFG())
    tcol = Collection("user_test", T_CFG(), device="cpu")
    embs = fill(jcol)
    assert fill(tcol) is not None
    ref = dense_arrays(jcol.dense)
    bits = tcol.dense.vecs.view(torch.int16).numpy().view(np.uint16)
    assert np.abs(bits.astype(np.int32) - ref["vecs"].astype(np.int32)
                  ).max() <= 1
    assert np.abs(tcol.dense.int8.numpy().astype(np.int32)
                  - ref["int8"].astype(np.int32)).max() <= 1
    np.testing.assert_allclose(tcol.dense.inv_norms.numpy(),
                               ref["inv_norms"], rtol=1e-6)
    tcol.dense = state.dense_from_numpy(T_CFG().index, ref, jcol.dense.size,
                                        jcol.dense.has_deletes, device="cpu")
    tcol._fused.dense = tcol.dense
    return jcol, tcol, embs


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def assert_same_hits(j_hits, t_hits):
    assert [h.row for h in t_hits] == [h.row for h in j_hits]
    np.testing.assert_allclose([h.score for h in t_hits],
                               [h.score for h in j_hits], rtol=1e-5)
    assert [h.payload for h in t_hits] == [h.payload for h in j_hits]


def test_embedder_matches_reference_and_caches():
    je, te = embedders()
    texts = ["same", "same", "alpha beta", "gamma", "delta epsilon zeta",
             "eta"]  # 6 texts: one full batch of 4 and a padded tail of 2
    ref = je.encode(texts)
    hits, misses = te.cache.hits, te.cache.misses
    out = te.encode(texts)
    assert out.shape == (6, 32) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_array_equal(out[0], out[1])  # identical texts
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    assert te.cache.misses == misses + 6
    # second call: every text is a cache hit, no device forward
    again = te.encode(texts)
    np.testing.assert_array_equal(again, out)
    assert te.cache.hits == hits + 6 and te.cache.misses == misses + 6
    # the tail padding changes nothing: alone (3 padded rows) == in a batch
    nocache = Embedder(te.state, batch_size=4, max_len=16,
                       cache=EmbeddingCache(capacity=0))
    np.testing.assert_allclose(nocache.encode_one("gamma"), out[3],
                               atol=1e-6)
    assert te.dim == 32 and not te.supports_audio and not te.supports_images
    with pytest.raises(NotImplementedError):
        te.encode_image(np.zeros((1, 224, 224, 3), dtype=np.float32))
    with pytest.raises(NotImplementedError):
        te.encode_audio(np.zeros((1, 256, 128), dtype=np.float32))


def test_store_and_search(pair):
    jcol, tcol, embs = pair
    assert tcol.chunk_count() == jcol.chunk_count() == 12
    assert tcol.chunk_count(document_id="doc-2") == 5
    for qi, text in ((3, "chunk number 3"), (8, None), (10, "hello")):
        j = jcol.hybrid_search(embs[qi], text, limit=3, adaptive=False)
        t = tcol.hybrid_search(embs[qi], text, limit=3, adaptive=False)
        assert_same_hits(j, t)
        assert t[0].row == qi
    j = jcol.hybrid_search_batch(embs[:4], TEXTS[:4], 5)
    t = tcol.hybrid_search_batch(embs[:4], TEXTS[:4], 5)
    for a, b in zip(j, t):
        assert_same_hits(a, b)


@pytest.mark.parametrize("filters", [dict(document_id="doc-2"),
                                     dict(kind="chat"),
                                     dict(user_id="u2", page=7)])
def test_filters(pair, filters):
    jcol, tcol, embs = pair
    j = jcol.hybrid_search(embs[1], None, limit=5, adaptive=False,
                           **filters)
    t = tcol.hybrid_search(embs[1], None, limit=5, adaptive=False,
                           **filters)
    assert_same_hits(j, t)
    assert t and all(all(h.payload.get(k) == v for k, v in filters.items())
                     for h in t)
    if filters == dict(kind="chat"):
        assert t[0].payload["thread_id"] == "thread-9"


def test_delete_document():
    jcol, tcol, embs = make_pair()
    assert jcol.delete_document("doc-1") == tcol.delete_document("doc-1") == 5
    assert tcol.chunk_count() == jcol.chunk_count() == 7
    for qi in (0, 6):
        j = jcol.hybrid_search(embs[qi], TEXTS[qi], limit=5, adaptive=False)
        t = tcol.hybrid_search(embs[qi], TEXTS[qi], limit=5, adaptive=False)
        assert_same_hits(j, t)
        assert all(h.payload["document_id"] != "doc-1" for h in t)
    assert tcol.delete_document("doc-1") == 0  # idempotent


def test_rerank_order(pair):
    """funnel.rerank reorders the hits by maxsim over re-encoded tokens,
    as the reference does."""
    jcol, tcol, embs = pair
    je, te = embedders()
    jf = JFunnelConfig(matryoshka_limits=(8, 6), dense_limit=5,
                       quantized_limit=5, sparse_limit=5, final_limit=5,
                       rerank=True)
    tf = FunnelConfig(**{k: getattr(jf, k) for k in jf.__dataclass_fields__})
    jcol.set_reranker(JReranker(je))
    tcol.set_reranker(LateInteractionReranker(te))
    try:
        q = ["topic2 subject2", "chunk number 7"]
        j = jcol.hybrid_search_batch(embs[[2, 7]], q, 5, funnel=jf)
        t = tcol.hybrid_search_batch(embs[[2, 7]], q, 5, funnel=tf)
        plain = tcol.hybrid_search_batch(embs[[2, 7]], q, 5,
                                         adaptive=False)
    finally:
        jcol.set_reranker(None)
        tcol.set_reranker(None)
    for a, b, c in zip(j, t, plain):
        assert [h.row for h in b] == [h.row for h in a]
        assert sorted(h.row for h in b) == sorted(h.row for h in c)


def test_text_batch_equals_encode_then_search(pair):
    """The tokens wire: `hybrid_search_text_batch` returns the hits of
    encode-then-`hybrid_search_batch` (and the reference's)."""
    jcol, tcol, _ = pair
    je, te = embedders()
    with pytest.raises(ValueError, match="bind_query_encoder"):
        Collection("x", T_CFG(), device="cpu").hybrid_search_text_batch(
            ["q"], 3)
    tcol.bind_query_encoder(te)
    jcol.bind_query_encoder(je)
    queries = ["chunk about topic3", "subject2 number", "hello kenobi"]
    classic = tcol.hybrid_search_batch(te.encode(queries), queries, 4)
    tok = tcol.hybrid_search_text_batch(queries, 4)
    ref = jcol.hybrid_search_text_batch(queries, 4)
    for a, b, c in zip(classic, tok, ref):
        assert_same_hits(a, b)
        assert_same_hits(c, b)
    filt = tcol.hybrid_search_text_batch(queries, 4, page=3)
    assert all(h.payload["page"] == 3 for hits in filt for h in hits)
    assert any(filt)


def test_vector_store_registry_and_unported():
    j, t = JVectorStore(J_CFG()), VectorStore(T_CFG(), device="cpu")
    for vs in (j, t):
        c1 = vs.get_or_create("alice")
        assert vs.get_or_create("alice") is c1
        vs.get_or_create("bob")
        assert vs.names() == ["user_alice", "user_bob"]
        assert vs.drop("bob") and not vs.drop("bob")
        assert [c.name for c in vs.collections()] == ["user_alice"]
    col = t.get_or_create("alice")
    assert col.device.type == "cpu" and col.dense.device.type == "cpu"
    with pytest.raises(NotImplementedError):
        col.build_ann()
    with pytest.raises(NotImplementedError):
        col.ann_search(np.zeros(32, dtype=np.float32))
    # dense, sparse and payload rows must stay aligned: both refuse a
    # batch whose embeddings do not match its chunks
    embs = np.ones((2, 32), dtype=np.float32)
    chunks = [{"text": "a"}, {"text": "b"}, {"text": "c"}]
    for c in (JCollection("d", J_CFG()), Collection("d", T_CFG(),
                                                    device="cpu")):
        with pytest.raises(AssertionError, match="row drift"):
            c.store_document_vectors("doc", chunks, embs)
