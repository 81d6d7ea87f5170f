"""Search orchestration (`search/orchestration.py`) and the request
micro-batcher (`search/batcher.py`) against the JAX reference, on the
CPU.

The orchestrator runs over a Collection and a KGStore in each package,
built from the same texts and upserts, embedded by encoders with the
same weights (f32 config; the flax weights carried over by
`state.encoder_params_from_jax`), with the reference's dense tables
carried into the port's by `state.dense_from_numpy`, and a STUB router
scripted the same way in both. `execute` and `ask` return the same hit
rows (scores within rtol 1e-5) and the same context string; the
parameter policies return the same funnels and graph parameters,
fallbacks and bounds included. The batcher cases are those of
tests/test_batcher.py, run against the port's class, plus a tokens-wire
batcher over a port Collection whose rows equal one direct
`hybrid_search_text_batch`.
"""

import asyncio
import dataclasses
import functools
import json
import re

import jax
import numpy as np
import pytest

from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import KGConfig as JKGConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.kg.store import KGStore as JKGStore
from rag_application_tpu.kg.store import Space as JSpace
from rag_application_tpu.llm.router import LLMRouter as JRouter
from rag_application_tpu.llm.router import Provider as JProvider
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.search import orchestration as jorch
from rag_application_tpu.search.batcher import _bucket as j_bucket
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, EncoderConfig
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import KGConfig, SparseConfig
from rag_application_tpu_torch.kg.store import KGStore, Space
from rag_application_tpu_torch.llm.router import LLMRouter, Provider
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.encoder import init_encoder
from rag_application_tpu_torch.search import orchestration as torch_orch
from rag_application_tpu_torch.search.batcher import MicroBatcher, _bucket
from rag_application_tpu_torch.store.collection import Collection

ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=16, out_dim=32, dtype="float32")
NAMES = ["vivek", "omnirag", "neo4j", "qdrant", "anthropic", "pallas",
         "hopper", "bm25"]
TEXTS = [f"{a} works with {b} on retrieval topic{i}"
         for i, (a, b) in enumerate(zip(NAMES * 2, NAMES[3:] + NAMES[:3]
                                        + NAMES))]
QUERIES = ["who created omnirag", "how does neo4j relate to vivek",
           "hopper kernels for bm25", "nothing known here"]


def small_config(cls, index, sparse, funnel):
    cfg = cls()
    cfg.index = index(dim=32, matryoshka_dims=(8, 16), initial_capacity=16)
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
    js = j_init(JEncoderConfig(**ECFG), max_len=16, seed=5)
    cfg = EncoderConfig(**ECFG)
    ts = init_encoder(cfg, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return (JEmbedder(js, batch_size=4, max_len=16),
            Embedder(ts, batch_size=4, max_len=16))


def dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": np.asarray(j.vecs).view(np.uint16),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def kg_pages(emb):
    """Two pages of entities (the names) and relationships between them."""
    out = []
    for page, names in ((1, NAMES[:5]), (2, NAMES[3:])):
        ents = [{"id": n, "text": n.capitalize(), "entity_type": "CONCEPT",
                 "entity_profile": f"{n} profile"} for n in names]
        rels = [{"source": a, "target": b, "relation_type": "RELATED_TO",
                 "relationship_profile": f"{a} relates to {b}"}
                for a, b in zip(names, names[1:])]
        out.append(dict(
            content=f"page {page}", embedding=emb.encode([f"page {page}"])[0],
            entities=ents, relationships=rels,
            entity_embeddings=emb.encode([n for n in names]),
            relationship_embeddings=emb.encode(
                [r["relationship_profile"] for r in rels])))
    return out


@functools.lru_cache(maxsize=None)
def stores():
    """(JAX collection, JAX KG, port collection, port KG); the port's
    tables are the reference's."""
    jemb, _ = embedders()
    embs = jemb.encode(TEXTS)
    chunks = [{"text": t} for t in TEXTS]
    jcol = JCollection("orch", J_CFG())
    tcol = Collection("orch", T_CFG(), device="cpu")
    for col in (jcol, tcol):
        col.store_document_vectors("doc", chunks, embs)
    tcol.dense = state.dense_from_numpy(T_CFG().index,
                                        dense_arrays(jcol.dense),
                                        jcol.dense.size,
                                        jcol.dense.has_deletes, device="cpu")
    tcol._fused.dense = tcol.dense
    jkg = JKGStore(JKGConfig(max_degree=8), dim=32)
    tkg = KGStore(KGConfig(max_degree=8), dim=32, device="cpu")
    for kg in (jkg, tkg):
        for page, kw in enumerate(kg_pages(jemb), start=1):
            kg.upsert_unstructured_page("doc", page, **kw)
    for s in Space:
        j = jkg.spaces[JSpace(s.value)].index
        tkg.spaces[s].index = state.dense_from_numpy(
            tkg.spaces[s].index.cfg, dense_arrays(j), j.size,
            j.has_deletes, device="cpu")
    return jcol, jkg, tcol, tkg


def script(llm, tuned):
    """The same stub behaviour in both packages: query entities are the
    known names in the prompt; an answer echoes the context's head."""
    def entities(prompt):
        found = [n for n in NAMES if re.search(rf"\b{n}\b", prompt)]
        return json.dumps({"entities": found, "relations": []})

    llm.stub.on(r"Extract the entities", entities)
    if tuned:
        llm.stub.on(r"Choose hybrid", lambda _: json.dumps({
            "matryoshka_64_limit": 12, "matryoshka_128_limit": 9,
            "dense_limit": 6, "quantized_limit": 700, "sparse_limit": 0,
            "final_limit": 3}))
        llm.stub.on(r"graph-search", lambda _: json.dumps({
            "search_depth": 3, "expansion_factor": 9,
            "relevance_threshold": 0.0, "max_paths": 2}))
    llm.stub.on(r"Context:", lambda p: "answer from " + p[9:60])
    return llm


def run_both(method, query, tuned):
    jcol, jkg, tcol, tkg = stores()
    jemb, temb = embedders()
    jo = jorch.SearchOrchestrator(jcol, jkg, jemb,
                                  script(JRouter(JProvider.STUB), tuned),
                                  llm_tuned_params=tuned)
    to = torch_orch.SearchOrchestrator(tcol, tkg, temb,
                                       script(LLMRouter(Provider.STUB), tuned),
                                       llm_tuned_params=tuned)
    return (asyncio.run(getattr(jo, method)(query, limit=4)),
            asyncio.run(getattr(to, method)(query, limit=4)))


def rows_scores(hits):
    return [h.row for h in hits], np.array([h.score for h in hits])


@pytest.mark.parametrize("tuned", [False, True])
@pytest.mark.parametrize("query", QUERIES)
def test_execute_matches_reference(query, tuned):
    j, t = run_both("execute", query, tuned)
    jr, js = rows_scores(j["hits"])
    tr, ts = rows_scores(t["hits"])
    assert tr == jr and tr
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    assert t["context"] == j["context"]
    for key in ("entities", "relationships"):
        assert [(h["space"], h["row"]) for h in t["graph"][key]] == \
            [(h["space"], h["row"]) for h in j["graph"][key]]
    assert t["graph"]["paths"] == j["graph"]["paths"]
    assert dataclasses.asdict(t["graph"]["params"]) == \
        dataclasses.asdict(j["graph"]["params"])
    if query != QUERIES[-1]:
        assert t["graph"]["entities"] and t["graph"]["paths"]


def test_ask_matches_reference():
    j, t = run_both("ask", QUERIES[0], False)
    assert t["answer"] == j["answer"] and t["answer"].startswith("answer")
    assert t["graph"] == j["graph"]
    assert [s["chunk_index"] for s in t["sources"]] == \
        [s["chunk_index"] for s in j["sources"]]
    np.testing.assert_allclose([s["score"] for s in t["sources"]],
                               [s["score"] for s in j["sources"]], rtol=1e-5)


SEARCH_REPLIES = {
    "values": {"matryoshka_64_limit": 100, "matryoshka_128_limit": 90,
               "matryoshka_256_limit": 70, "dense_limit": 50,
               "quantized_limit": 40, "sparse_limit": 30, "final_limit": 10,
               "hnsw_ef": 256},
    "bounds": {"matryoshka_64_limit": 5000, "dense_limit": 1,
               "sparse_limit": -3, "final_limit": 999},
    "zeros": {"final_limit": 0, "dense_limit": 0},
    "not_json": "not json at all {{{",
    "bad_type": {"dense_limit": "many"},
}
GRAPH_REPLIES = {
    "bounds": {"search_depth": 99, "expansion_factor": 1,
               "relevance_threshold": 0.5, "max_paths": 100},
    "zero_threshold": {"search_depth": 0, "relevance_threshold": 0.0},
    "high": {"relevance_threshold": 7, "expansion_factor": 500},
    "null_threshold": {"relevance_threshold": None, "max_paths": 0},
    "not_json": "{{",
    "bad_type": {"search_depth": "deep"},
}


def _reply(value):
    return value if isinstance(value, str) else json.dumps(value)


@pytest.mark.parametrize("corpus", [100, 100_000])
@pytest.mark.parametrize("case", list(SEARCH_REPLIES))
def test_determine_search_params(case, corpus):
    outs = []
    for router, provider, mod, funnel in (
            (JRouter, JProvider, jorch, JFunnelConfig),
            (LLMRouter, Provider, torch_orch, FunnelConfig)):
        llm = router(provider.STUB)
        llm.stub.on(r"Choose hybrid",
                    lambda _: _reply(SEARCH_REPLIES[case]))
        outs.append(dataclasses.asdict(asyncio.run(
            mod.determine_search_params(llm, "q", corpus,
                                        funnel(final_limit=7)))))
    assert outs[0] == outs[1]
    if case == "values":
        assert outs[1]["matryoshka_limits"][0] == 128  # bucketed
    if case == "not_json" and corpus == 100_000:
        assert outs[1]["matryoshka_limits"][0] == 512  # adaptive fallback


@pytest.mark.parametrize("case", list(GRAPH_REPLIES))
def test_determine_graph_params(case):
    outs = []
    for router, provider, mod in ((JRouter, JProvider, jorch),
                                  (LLMRouter, Provider, torch_orch)):
        llm = router(provider.STUB)
        llm.stub.on(r"graph", lambda _: _reply(GRAPH_REPLIES[case]))
        outs.append(dataclasses.asdict(asyncio.run(
            mod.determine_graph_params(llm, "q"))))
    assert outs[0] == outs[1]
    if case == "bounds":
        assert (outs[1]["search_depth"], outs[1]["expansion_factor"],
                outs[1]["max_paths"]) == (3, 8, 20)
    if case == "zero_threshold":
        assert outs[1]["relevance_threshold"] == 0.0


# --------------------------------------------------------------- batcher


def test_bucket_powers_of_two():
    assert [_bucket(n) for n in (1, 2, 3, 5, 9, 64, 65)] == \
        [1, 2, 4, 8, 16, 64, 128]
    assert _bucket(5000) == 2048  # capped
    assert all(_bucket(n) == j_bucket(n) for n in range(1, 3000, 7))


def test_concurrent_requests_share_one_dispatch():
    calls = []

    def run_batch(embs, texts, limit):
        calls.append(embs.shape[0])
        return [[("hit", float(embs[i, 0]), limit)] * limit
                for i in range(embs.shape[0])]

    async def main():
        b = MicroBatcher(run_batch, max_wait_ms=10.0)
        outs = await asyncio.gather(*(
            b.search(np.full(4, float(i)), f"q{i}", limit=1 + i % 3)
            for i in range(20)))
        for i, hits in enumerate(outs):
            assert hits[0][1] == float(i)
            assert len(hits) == 1 + i % 3
        assert b.requests_served == 20
        assert b.batches_run <= 3
        assert all(n & (n - 1) == 0 for n in calls)

    asyncio.run(main())


def test_lone_request_latency_and_errors():
    def boom(embs, texts, limit):
        raise RuntimeError("engine down")

    async def main():
        ok = MicroBatcher(lambda e, t, k: [[1]] * e.shape[0],
                          max_wait_ms=1.0)
        t0 = asyncio.get_running_loop().time()
        out = await ok.search(np.zeros(4), None, 1)
        assert out == [1]
        assert asyncio.get_running_loop().time() - t0 < 0.5
        bad = MicroBatcher(boom, max_wait_ms=1.0)
        with pytest.raises(RuntimeError, match="engine down"):
            await bad.search(np.zeros(4), None, 1)

    asyncio.run(main())


def test_mixed_embedding_group_resolves_every_future():
    """A window mixing embedding=None and ndarray submissions resolves
    every future, and the worker survives for the next group."""
    seen = []

    def run_batch(embs, texts, limit):
        seen.append(None if embs is None else embs.shape[0])
        return [["ok"]] * (embs.shape[0] if embs is not None else len(texts))

    async def main():
        b = MicroBatcher(run_batch, max_wait_ms=10.0)
        results = await asyncio.wait_for(asyncio.gather(
            b.search(None, "query one", 1),
            b.search(np.zeros(4, dtype=np.float32), "query two", 1),
            b.search(None, "query three", 1),
            return_exceptions=True), timeout=10)
        assert results == [["ok"]] * 3
        out = await asyncio.wait_for(b.search(None, "query four", 1),
                                     timeout=10)
        assert out == ["ok"]

    asyncio.run(main())
    # the window's two parts ran apart, the texts-only one padded to 2
    assert sorted(seen[:2], key=str) == [1, None]


def test_tokens_wire_batcher_over_a_collection():
    """The API's batcher (tokens wire, max_inflight 2) over a port
    Collection: concurrent requests, each answered with the rows of one
    direct `hybrid_search_text_batch` of all the texts."""
    _, temb = embedders()
    col = Collection("wire", T_CFG(), device="cpu")
    col.store_document_vectors("doc", [{"text": t} for t in TEXTS],
                               temb.encode(TEXTS))
    col.bind_query_encoder(temb)
    texts = [TEXTS[i % len(TEXTS)] + f" extra{i}" for i in range(24)]
    direct = [[h.row for h in hits]
              for hits in col.hybrid_search_text_batch(texts, 4)]

    async def main():
        b = MicroBatcher(lambda e, t, k: col.hybrid_search_text_batch(t, k),
                         max_batch=8, max_wait_ms=2.0, max_inflight=2)
        outs = await asyncio.wait_for(asyncio.gather(
            *(b.search(None, t, 4) for t in texts)), timeout=60)
        return b, [[h.row for h in hits] for hits in outs]

    b, rows = asyncio.run(main())
    assert rows == direct
    assert b.requests_served == 24 and 3 <= b.batches_run < 24


def test_shared_state_under_threads():
    """What the batcher's and the orchestrator's threads share: launch
    counts, the TF32 switch and the embedding cache, hammered by more
    threads than cores with a short switch interval. No count is lost,
    TF32 stays off while any thread is inside `full_f32_matmul` and comes
    back after the last, and the LRU never raises."""
    import os
    import sys
    import threading
    import time

    import torch

    from rag_application_tpu_torch.kernels import count_launch
    from rag_application_tpu_torch.models.cache import EmbeddingCache
    from rag_application_tpu_torch.utils import full_f32_matmul

    def wrapper():
        pass

    wrapper.launches = 0
    by = {"a": 0}
    cache = EmbeddingCache(capacity=8)
    vec = np.zeros(4, dtype=np.float32)
    errors, tf32_seen = [], []
    threads_n, rounds = 2 * (os.cpu_count() or 4), 300

    def work(i):
        try:
            for j in range(rounds):
                count_launch(wrapper, by, "a")
                with full_f32_matmul():
                    time.sleep(0)  # let another thread enter or leave
                    tf32_seen.append(torch.backends.cuda.matmul.allow_tf32)
                key = f"t{(i + j) % 12}"
                cache.put(key, vec)
                cache.get(key)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    switch = sys.getswitchinterval()
    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        sys.setswitchinterval(switch)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    assert not errors, errors
    assert wrapper.launches == by["a"] == threads_n * rounds
    assert not any(tf32_seen) and len(tf32_seen) == threads_n * rounds
    assert len(cache) <= 8
