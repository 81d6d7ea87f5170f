"""The knowledge-search toolbox (`tools/knowledge.py`) against the JAX
reference's, on the CPU.

Both toolboxes are built as tests/test_knowledge_tools.py builds its
one: a Collection of three chunks, a KGStore with a document, a page of
entities and relationships and a structured sheet, embedded by encoders
with the same weights (the flax weights carried by
`state.encoder_params_from_jax`). The reference's dense tables (the
collection's and the KG's four spaces) are carried into the port's by
`state.dense_from_numpy`, so both search the same rows. Every tool, on
every case of that file and a few more (missing ids, an unreachable
pair, a query-pruned traversal, bad structured queries), returns the
same JSON, floats within 1e-5; the specs agents bind are equal; and the
port passes that file's assertions.
"""

import asyncio
import functools
import json

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
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu.tools.knowledge import \
    KnowledgeSearchToolbox as JToolbox
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, EncoderConfig
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import KGConfig, SparseConfig
from rag_application_tpu_torch.kg.store import KGStore, Space
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.encoder import init_encoder
from rag_application_tpu_torch.store.collection import Collection
from rag_application_tpu_torch.tools.knowledge import KnowledgeSearchToolbox

ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=32, out_dim=32, dtype="float32")
TEXTS = ["vivek created the omnirag platform",
         "omnirag uses neo4j for graph storage",
         "the benchmark measures recall at ten"]
ENTS = [
    {"id": "vivek", "text": "Vivek", "entity_type": "PERSON",
     "entity_profile": "engineer"},
    {"id": "omnirag", "text": "OmniRAG", "entity_type": "PRODUCT",
     "entity_profile": "rag platform"},
    {"id": "neo4j", "text": "Neo4j", "entity_type": "TECHNOLOGY",
     "entity_profile": "graph database"},
]
RELS = [
    {"source": "vivek", "target": "omnirag", "relation_type": "CREATED",
     "relationship_profile": "vivek created omnirag"},
    {"source": "omnirag", "target": "neo4j", "relation_type": "USES",
     "relationship_profile": "omnirag uses neo4j"},
]


def small_config(cls, index, sparse, funnel):
    cfg = cls()
    cfg.index = index(dim=32, matryoshka_dims=(8, 16), initial_capacity=16)
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    return cfg


@functools.lru_cache(maxsize=None)
def embedders():
    js = j_init(JEncoderConfig(**ECFG), max_len=16, seed=5)
    cfg = EncoderConfig(**ECFG)
    ts = init_encoder(cfg, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return (JEmbedder(js, batch_size=4, max_len=16),
            Embedder(ts, batch_size=4, max_len=16))


def fill(col, kg, emb):
    """test_knowledge_tools.py's stores."""
    col.store_document_vectors("resume.pdf", [{"text": t} for t in TEXTS],
                               emb.encode(TEXTS))
    kg.upsert_document("resume.pdf", {"title": "Resume", "author": "vivek"})

    def kv(t):
        return emb.encode([t])[0]

    kg.upsert_unstructured_page(
        "resume.pdf", 1, content="resume page one about vivek",
        embedding=kv("resume page one"), entities=ENTS, relationships=RELS,
        entity_embeddings=np.stack([kv(e["entity_profile"]) for e in ENTS]),
        relationship_embeddings=np.stack(
            [kv(r["relationship_profile"]) for r in RELS]))
    kg.upsert_structured_sheet(
        "data.csv", 1, sheet_name="people", summary="a table of people",
        summary_embedding=kv("a table of people"),
        columns=[{"name": "name", "profile": "person names"}],
        column_embeddings=np.stack([kv("person names")]),
        rows=[{"name": "alice"}, {"name": "bob"}])


def dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": np.asarray(j.vecs).view(np.uint16),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def carried(cfg, j):
    return state.dense_from_numpy(cfg, dense_arrays(j), j.size,
                                  j.has_deletes, device="cpu")


@functools.lru_cache(maxsize=None)
def toolboxes():
    """(the JAX toolbox, the port's, the port's stores)."""
    jemb, temb = embedders()
    jcol = JCollection("kt", small_config(JConfig, JIndexConfig,
                                          JSparseConfig, JFunnelConfig))
    jkg = JKGStore(JKGConfig(max_degree=8), dim=32)
    tcol = Collection("kt", small_config(Config, IndexConfig, SparseConfig,
                                         FunnelConfig), device="cpu")
    tkg = KGStore(KGConfig(max_degree=8), dim=32, device="cpu")
    fill(jcol, jkg, jemb)
    fill(tcol, tkg, temb)
    tcol.dense = carried(tcol.cfg.index, jcol.dense)
    tcol._fused.dense = tcol.dense
    for s in Space:
        table = tkg.spaces[s]
        table.index = carried(table.index.cfg,
                              jkg.spaces[JSpace(s.value)].index)
    tkg._adj_cache = None
    return (JToolbox(jcol, jkg, jemb).build(),
            KnowledgeSearchToolbox(tcol, tkg, temb).build(), (tcol, tkg))


def run(reg, name, **kw):
    return asyncio.run(reg.get(name).call(**kw))


def jsonable(x):
    return json.loads(json.dumps(x, default=str))


def assert_same_json(got, want, path="$"):
    """Equal JSON, floats within 1e-5."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(
            want, (int, float)), path
        assert abs(got - want) <= 1e-5, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


CASES = {
    "search_documents": [{"query": "resume"}, {"query": "vivek", "k": 1},
                         {"query": "nothing"}],
    "list_documents": [{}],
    "get_document_metadata": [{"document_id": "resume.pdf"},
                              {"document_id": "missing"}],
    "list_document_pages": [{"document_id": "resume.pdf"},
                            {"document_id": "data.csv"}],
    "get_page_content": [{"document_id": "resume.pdf", "page_number": 1},
                         {"document_id": "resume.pdf", "page_number": 9}],
    "search_pages_semantic": [{"query": "resume page one"}],
    "search_entities_semantic": [{"query": "graph database"},
                                 {"query": "engineer", "k": 2}],
    "search_relationships_semantic": [{"query": "omnirag uses neo4j"}],
    "search_columns_semantic": [{"query": "person names"}],
    "search_across_spaces": [{"query": "rag platform", "k": 5},
                             {"query": "vivek"}],
    "hybrid_search": [{"query": "omnirag neo4j graph storage"},
                      {"query": "benchmark recall", "k": 2}],
    "get_entity_by_id": [{"entity_id": "omnirag"},
                         {"entity_id": "vivek", "document_id": "resume.pdf"},
                         {"entity_id": "missing"}],
    "find_entities_by_type": [{"entity_type": "PERSON"},
                              {"entity_type": "TECHNOLOGY", "k": 1}],
    "get_entity_context": [{"entity_id": "omnirag"},
                           {"entity_id": "missing"}],
    "traverse_entity_graph": [{"entity_id": "vivek", "hops": 2},
                              {"entity_id": "neo4j", "hops": 1,
                               "query": "rag platform"},
                              {"entity_id": "missing"}],
    "path_between_entities": [
        {"source_id": "vivek", "target_id": "neo4j"},
        {"source_id": "vivek", "target_id": "vivek"},
        {"source_id": "neo4j", "target_id": "vivek", "max_hops": 1},
        {"source_id": "vivek", "target_id": "missing"}],
    "get_relationships_between": [
        {"source_id": "vivek", "target_id": "omnirag"},
        {"source_id": "vivek", "target_id": "neo4j"}],
    "get_column_values": [{"column_name": "name"},
                          {"column_name": "name", "sheet_name": "people",
                           "k": 1},
                          {"column_name": "age"}],
    "search_row_values": [{"value": "alice"}, {"value": "B"},
                          {"value": "zed"}],
    "get_chunk_neighbors": [{"document_id": "resume.pdf", "chunk_index": 1,
                             "radius": 1},
                            {"document_id": "resume.pdf", "chunk_index": 0}],
    "structured_query": [{"operation": "stats"},
                         {"operation": "chunk_count"},
                         {"operation": "documents"},
                         {"operation": "entities_of_document",
                          "args": '{"document_id": "resume.pdf"}'},
                         {"operation": "drop_everything"},
                         {"operation": "stats", "args": "{not json"}],
}


def test_the_same_21_tools():
    jreg, treg, _ = toolboxes()
    assert len(treg) == len(jreg) == 21
    assert treg.names() == jreg.names() == sorted(CASES)
    assert treg.specs() == jreg.specs()


@pytest.mark.parametrize("name,kw", [(n, kw) for n, cases in CASES.items()
                                     for kw in cases])
def test_tool_output_matches_reference(name, kw):
    jreg, treg, _ = toolboxes()
    want = jsonable(run(jreg, name, **kw))
    got = jsonable(run(treg, name, **kw))
    assert_same_json(got, want)


# --------------------------- tests/test_knowledge_tools.py, on the port

def test_document_tools():
    _, reg, _ = toolboxes()
    hits = run(reg, "search_documents", query="resume")
    assert hits and hits[0]["document_id"] == "resume.pdf"
    docs = run(reg, "list_documents")
    assert {d["document_id"] for d in docs} >= {"resume.pdf", "data.csv"}
    assert run(reg, "get_document_metadata",
               document_id="resume.pdf")["author"] == "vivek"
    assert run(reg, "list_document_pages",
               document_id="resume.pdf")[0]["page_number"] == 1
    assert "vivek" in run(reg, "get_page_content", document_id="resume.pdf",
                          page_number=1)["content"]


def test_semantic_space_tools():
    _, reg, _ = toolboxes()
    hits = run(reg, "search_entities_semantic", query="graph database")
    assert hits and hits[0]["space"] == "entity"
    hits = run(reg, "search_across_spaces", query="rag platform", k=5)
    assert hits and len({h["space"] for h in hits}) >= 2


def test_hybrid_search_tool():
    _, reg, _ = toolboxes()
    hits = run(reg, "hybrid_search", query="omnirag neo4j graph storage")
    assert hits and "neo4j" in hits[0]["text"]


def test_entity_graph_tools():
    _, reg, _ = toolboxes()
    assert run(reg, "get_entity_by_id",
               entity_id="omnirag")["entity_type"] == "PRODUCT"
    assert [p["id"] for p in run(reg, "find_entities_by_type",
                                 entity_type="PERSON")] == ["vivek"]
    ctx = run(reg, "get_entity_context", entity_id="omnirag")
    assert {r["relationship"]["relation_type"]
            for r in ctx["relationships"]} == {"CREATED", "USES"}
    trav = run(reg, "traverse_entity_graph", entity_id="vivek", hops=2)
    assert {t["id"] for t in trav} == {"vivek", "omnirag", "neo4j"}
    path = run(reg, "path_between_entities", source_id="vivek",
               target_id="neo4j")
    assert path["reachable"] and path["hops"] == 2
    rels = run(reg, "get_relationships_between", source_id="vivek",
               target_id="omnirag")
    assert rels and rels[0]["relation_type"] == "CREATED"


def test_table_tools():
    _, reg, _ = toolboxes()
    col = run(reg, "get_column_values", column_name="name")
    assert [v["value"] for v in col["values"]] == ["alice", "bob"]
    hits = run(reg, "search_row_values", value="alice")
    assert hits and hits[0]["match"]["value"] == "alice"


def test_chunk_neighbors_and_structured_query():
    _, reg, _ = toolboxes()
    out = run(reg, "get_chunk_neighbors", document_id="resume.pdf",
              chunk_index=1, radius=1)
    assert [c["chunk_index"] for c in out] == [0, 1, 2]
    assert run(reg, "structured_query", operation="stats")["entity"] == 3
    err = run(reg, "structured_query", operation="drop_everything")
    assert "unknown operation" in err["error"]


def test_path_runs_on_the_kg_device(monkeypatch):
    """`path_between_entities` hands the port's `path_first_hop` int32
    tensors on the adjacency's device."""
    from rag_application_tpu_torch.ops import graph_hop

    _, reg, (_, tkg) = toolboxes()
    seen = []
    real = graph_hop.path_first_hop

    def spy(adj, src, dst, hops):
        seen.append((src.dtype, dst.dtype, src.device, adj.device, hops))
        return real(adj, src, dst, hops)

    monkeypatch.setattr(graph_hop, "path_first_hop", spy)
    assert run(reg, "path_between_entities", source_id="vivek",
               target_id="neo4j") == {"reachable": True, "hops": 2}
    import torch
    assert seen == [(torch.int32, torch.int32, tkg.device, tkg.device, 3)]
