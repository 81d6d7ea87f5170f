"""The knowledge graph (`kg/store.py`, `kg/dedup.py`, `kg/extract.py`,
`kg/checkpoint.py`) against the JAX reference, on the CPU.

Both stores take the same upserts. Their host state (documents, pages,
keys, payloads, edges, mentions, columns) and `stats()` are equal; their
tables differ only by the prep pass's rounding (bf16 within one ulp,
int8 within one step; tests/test_torch_prep.py). The read checks then
carry the reference's tables into the port's spaces with
`state.dense_from_numpy`, as the funnel tests do: `search_space` and
`search_across_spaces` give equal ids with scores within rtol 1e-5;
`traverse` and `entity_context` agree, ids differing only where two beam
scores lie within the f32 dot bound 2 d 2^-24 (reported, none at these
seeds). Duplicate pairs are equal (scores rtol 1e-5), merges leave equal
stores, extraction parses the same stub output the same way, and KG
snapshots written by either package load in the other with bit-equal
tables and byte-equal files.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from rag_application_tpu.config import KGConfig as JKGConfig
from rag_application_tpu.kg import dedup as jdedup
from rag_application_tpu.kg.checkpoint import load_kg as j_load_kg
from rag_application_tpu.kg.checkpoint import save_kg as j_save_kg
from rag_application_tpu.kg.extract import \
    EntityRelationExtractor as JExtractor
from rag_application_tpu.kg.store import KGStore as JKGStore
from rag_application_tpu.kg.store import Space as JSpace
from rag_application_tpu.llm.router import LLMRouter as JRouter
from rag_application_tpu.llm.router import Provider as JProvider
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import KGConfig
from rag_application_tpu_torch.kg import dedup as tdedup
from rag_application_tpu_torch.kg.checkpoint import load_kg, save_kg
from rag_application_tpu_torch.kg.extract import EntityRelationExtractor
from rag_application_tpu_torch.kg.store import KGStore, Space
from rag_application_tpu_torch.llm.router import LLMRouter, Provider

DIM = 64
SCOPE = {"user_id": "u1", "org_id": "o1"}
KG_FILES = ("spaces.npz", "graph.json", "manifest.json")


def unit(r, n):
    v = r.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def page_content(r, doc, page, n_ent=6, n_rel=7):
    names = [f"{doc}-p{page}-e{i}" for i in range(n_ent)]
    ents = [{"id": n, "text": f"Entity {n}", "entity_type":
             ["PERSON", "PRODUCT", "CONCEPT"][i % 3],
             "entity_profile": f"profile of {n}"}
            for i, n in enumerate(names)]
    if page > 1:  # an entity shared with page 1 (MERGE across pages)
        ents[0] = dict(ents[0], id=f"{doc}-p1-e0")
    rels = []
    for j in range(n_rel):
        a, b = r.choice(n_ent, 2, replace=False)
        rels.append({"source": ents[a]["id"], "target": ents[b]["id"],
                     "relation_type": ["USES", "CREATED"][j % 2],
                     "relationship_profile": f"rel {j}"})
    return ents, rels


def operations(seed=0):
    """The upserts both stores take: three documents of pages with
    entities and relationships (a page re-upserted, an entity MERGEd
    across pages, a duplicate relationship key), and a structured sheet."""
    r = np.random.default_rng(seed)
    ops = []
    for doc in ("a.pdf", "b.pdf", "c.pdf"):
        for page in (1, 2):
            ents, rels = page_content(r, doc, page)
            if doc == "b.pdf" and page == 2:
                rels.append(dict(rels[0]))  # the same key twice
            ops.append(("page", doc, page, dict(
                content=f"{doc} page {page}", embedding=unit(r, 1)[0],
                entities=ents, relationships=rels,
                entity_embeddings=unit(r, len(ents)),
                relationship_embeddings=unit(r, len(rels)))))
    ents, rels = page_content(r, "a.pdf", 1)  # re-upsert a page
    ops.append(("page", "a.pdf", 1, dict(
        content="a.pdf page 1 v2", embedding=unit(r, 1)[0], entities=ents,
        relationships=rels, entity_embeddings=unit(r, len(ents)),
        relationship_embeddings=unit(r, len(rels)))))
    ops.append(("sheet", "s.xlsx", 1, dict(
        sheet_name="Sheet1", summary="sales by region",
        summary_embedding=unit(r, 1)[0],
        columns=[{"name": "region"}, {"name": "sales"}],
        column_embeddings=unit(r, 2),
        rows=[{"region": "EU", "sales": 3}, {"region": "US", "sales": 5}])))
    return ops


def apply(kg, ops):
    for kind, doc, page, kw in ops:
        if kind == "page":
            kg.upsert_unstructured_page(doc, page, **kw)
        else:
            kg.upsert_structured_sheet(doc, page, **kw)


def host_state(kg):
    tables = {s.value: (t.payloads, t.by_key,
                        {k: dict(v) for k, v in t.by_id.items()}, t.index.size)
              for s, t in kg.spaces.items()}
    return (kg.documents, kg.doc_pages, kg.entity_edges, kg.page_mentions,
            kg.column_values, kg.page_columns, tables)


def dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": np.asarray(j.vecs).view(np.uint16),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def assert_tables_close(tkg, jkg):
    """The port's prep rounding: bf16 within one ulp, int8 one step."""
    for s in Space:
        t, j = tkg.spaces[s].index, jkg.spaces[JSpace(s.value)].index
        bits = t.vecs.view(torch.int16).numpy().view(np.uint16)
        ref = np.asarray(j.vecs).view(np.uint16)
        assert np.abs(bits.astype(np.int32) - ref.astype(np.int32)).max() <= 1
        assert np.abs(t.int8.numpy().astype(np.int32)
                      - np.asarray(j.int8).astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(t.live.numpy(), np.asarray(j.live))


def carry_tables(tkg, jkg):
    """The reference's tables into the port's spaces."""
    for s in Space:
        j = jkg.spaces[JSpace(s.value)].index
        table = tkg.spaces[s]
        table.index = state.dense_from_numpy(
            table.index.cfg, dense_arrays(j), j.size, j.has_deletes,
            device="cpu")
    tkg._adj_cache = None


def assert_tables_equal(tkg, jkg):
    for s in Space:
        t, j = tkg.spaces[s].index, jkg.spaces[JSpace(s.value)].index
        assert t.size == j.size and t.capacity == j.capacity
        np.testing.assert_array_equal(
            t.vecs.view(torch.int16).numpy().view(np.uint16),
            np.asarray(j.vecs).view(np.uint16))
        np.testing.assert_array_equal(t.int8.numpy(), np.asarray(j.int8))
        np.testing.assert_array_equal(t.live.numpy(), np.asarray(j.live))


def make_pair(kg_cfg=None, ops=None):
    jkg = JKGStore(JKGConfig(max_degree=8), dim=DIM, scope=dict(SCOPE))
    tkg = KGStore(kg_cfg or KGConfig(max_degree=8), dim=DIM,
                  scope=dict(SCOPE), device="cpu")
    ops = operations() if ops is None else ops
    apply(jkg, ops)
    apply(tkg, ops)
    return jkg, tkg


def assert_hits_equal(th, jh):
    assert [(h["space"], h["row"]) for h in th] == \
        [(h["space"], h["row"]) for h in jh]
    np.testing.assert_allclose([h["score"] for h in th],
                               [h["score"] for h in jh], rtol=1e-5)
    strip = [{k: v for k, v in h.items() if k != "score"} for h in th]
    assert strip == [{k: v for k, v in h.items() if k != "score"}
                     for h in jh]


def test_upserts_give_equal_stores():
    jkg, tkg = make_pair()
    assert tkg.stats() == jkg.stats()
    assert tkg.stats()["entity"] > 0 and tkg.stats()["column"] == 2
    assert host_state(tkg) == host_state(jkg)
    assert_tables_close(tkg, jkg)
    assert tkg.get_pages("a.pdf") == jkg.get_pages("a.pdf")
    assert tkg.get_entities("b.pdf") == jkg.get_entities("b.pdf")
    assert tkg.get_document("c.pdf") == jkg.get_document("c.pdf")


def test_search_space_and_across_spaces():
    jkg, tkg = make_pair()
    carry_tables(tkg, jkg)
    r = np.random.default_rng(3)
    ent = jkg.spaces[JSpace.ENTITY].index
    for row in (0, 5, 17):
        q = np.asarray(ent.vecs[row], dtype=np.float32) \
            + 0.1 * r.standard_normal(DIM).astype(np.float32)
        for s in Space:
            assert_hits_equal(tkg.search_space(s, q, k=4),
                              jkg.search_space(JSpace(s.value), q, k=4))
        assert_hits_equal(
            tkg.search_space(Space.ENTITY, q, k=5, entity_type="PERSON"),
            jkg.search_space(JSpace.ENTITY, q, k=5, entity_type="PERSON"))
        assert_hits_equal(tkg.search_across_spaces(q, k=6),
                          jkg.search_across_spaces(q, k=6))
        assert_hits_equal(
            tkg.search_across_spaces(q, k=6, spaces=[Space.PAGE,
                                                     Space.RELATIONSHIP]),
            jkg.search_across_spaces(q, k=6, spaces=[JSpace.PAGE,
                                                     JSpace.RELATIONSHIP]))


def beam_scores(jkg, q):
    ent = jkg.spaces[JSpace.ENTITY].index
    n = ent.size
    qn = q / np.linalg.norm(q)
    return np.asarray(ent.vecs[:n], dtype=np.float32) @ qn


def compare_paths(tp, jp, scores, tol):
    """Equal, or differing only among nodes whose beam scores are within
    ``tol`` of each other. Returns the number of such near-ties."""
    ties = 0
    for a, b in zip(tp, jp):
        ka = [(h["hop"], h["row"]) for h in a]
        kb = [(h["hop"], h["row"]) for h in b]
        if ka == kb:
            assert a == b
            continue
        diff = sorted(set(ka) ^ set(kb))
        assert scores is not None, (ka, kb)
        s = scores[[row for _, row in diff]]
        assert s.max() - s.min() <= tol, (diff, s)
        ties += 1
    return ties


@pytest.mark.parametrize("cap", [2, 64])
def test_traverse_and_entity_context(cap):
    jkg, tkg = make_pair()
    carry_tables(tkg, jkg)
    np.testing.assert_array_equal(tkg.entity_adjacency()[0].numpy(),
                                  np.asarray(jkg.entity_adjacency()[0]))
    rows = [jkg._find_entity_row(f"{d}-p1-e{i}", d)
            for d, i in (("a.pdf", 0), ("b.pdf", 2), ("c.pdf", 3))]
    rows.append(10 ** 6)  # a seed outside the graph
    r = np.random.default_rng(5)
    q = r.standard_normal(DIM).astype(np.float32)
    tol = 2 * DIM * 2.0 ** -24
    ties = 0
    for hops in (1, 2, 3, 9):
        ties += compare_paths(tkg.traverse(rows, hops, frontier_cap=cap),
                              jkg.traverse(rows, hops, frontier_cap=cap),
                              None, tol)
        ties += compare_paths(
            tkg.traverse(rows, hops, query_embedding=q, frontier_cap=cap),
            jkg.traverse(rows, hops, query_embedding=q, frontier_cap=cap),
            beam_scores(jkg, q), tol)
    print(f"traverse near-ties (cap {cap}): {ties}")
    out = tkg.traverse(rows[:1], 2)
    assert {h["hop"] for h in out[0]} >= {0, 1}
    for row in rows[:3] + [0, 10 ** 6]:
        assert tkg.entity_context(row) == jkg.entity_context(row)


@pytest.mark.parametrize("op", ["reset_document", "delete_document"])
def test_document_deletes(op):
    jkg, tkg = make_pair()
    assert getattr(tkg, op)("b.pdf") == getattr(jkg, op)("b.pdf") > 0
    assert getattr(tkg, op)("b.pdf") == getattr(jkg, op)("b.pdf") == 0
    assert tkg.stats() == jkg.stats()
    assert host_state(tkg) == host_state(jkg)
    # a later upsert drops the edge pairs of the tombstoned relationships
    more = [op_ for op_ in operations(seed=1) if op_[1] == "c.pdf"][:1]
    apply(jkg, more)
    apply(tkg, more)
    assert host_state(tkg) == host_state(jkg)
    carry_tables(tkg, jkg)
    q = np.asarray(jkg.spaces[JSpace.ENTITY].index.vecs[3], dtype=np.float32)
    assert_hits_equal(tkg.search_across_spaces(q, k=8),
                      jkg.search_across_spaces(q, k=8))


def test_structured_sheet_replace():
    jkg, tkg = make_pair()
    r = np.random.default_rng(9)
    kw = dict(sheet_name="Sheet1", summary="sales v2",
              summary_embedding=unit(r, 1)[0], columns=[{"name": "sales"}],
              column_embeddings=unit(r, 1), rows=[{"sales": 7}])
    for kg in (jkg, tkg):
        kg.upsert_structured_sheet("s.xlsx", 1, **kw)
    assert tkg.stats() == jkg.stats() and tkg.stats()["column"] == 1
    assert host_state(tkg) == host_state(jkg)


def dedup_ops():
    """One page whose entities hold groups of near-duplicates (the same
    name with small edits, vectors within ~0.02) and distinct ones."""
    r = np.random.default_rng(12)
    base = unit(r, 4)
    names = ["Anthropic", "Anthropic.", "anthropic", "DeepMind",
             "Deep Mind", "OpenAI", "Open AI Inc", "Mistral", "Mistral"]
    groups = [0, 0, 0, 1, 1, 2, 2, 3, 3]
    embs = base[groups] + 0.02 * r.standard_normal(
        (len(names), DIM)).astype(np.float32)
    ents = [{"id": f"e{i}", "text": n, "entity_type": "ORG",
             "entity_profile": "lab", "occurrences": 1 + i % 3}
            for i, n in enumerate(names)]
    ents[8]["entity_type"] = "PERSON"  # same text, other type
    rels = [{"source": f"e{a}", "target": f"e{b}",
             "relation_type": "RELATED_TO", "relationship_profile": "x"}
            for a, b in ((1, 3), (2, 5), (4, 6), (0, 7), (1, 2))]
    return [("page", "d", 1, dict(
        content="c", embedding=unit(r, 1)[0], entities=ents,
        relationships=rels, entity_embeddings=embs,
        relationship_embeddings=unit(r, len(rels))))]


def test_find_and_merge_duplicates():
    jkg, tkg = make_pair(ops=dedup_ops())
    carry_tables(tkg, jkg)
    jp = jdedup.find_duplicates(jkg)
    tp = tdedup.find_duplicates(tkg)
    assert [p[:2] for p in tp] == [p[:2] for p in jp] and len(tp) >= 3
    np.testing.assert_allclose([p[2] for p in tp], [p[2] for p in jp],
                               rtol=1e-5)
    loose = dict(score_threshold=0.0, string_threshold=0.0)
    assert [p[:2] for p in tdedup.find_duplicates(tkg, **loose)] == \
        [p[:2] for p in jdedup.find_duplicates(jkg, **loose)]
    assert tdedup.merge_duplicates(tkg, tp) == \
        jdedup.merge_duplicates(jkg, jp) > 0
    assert tkg.stats() == jkg.stats()
    assert host_state(tkg) == host_state(jkg)
    assert_tables_equal(tkg, jkg)
    # a second pass finds nothing more to merge in either
    assert tdedup.deduplicate(tkg) == jdedup.deduplicate(jkg)
    assert host_state(tkg) == host_state(jkg)
    for a, b in (("kitten", "sitting"), ("", ""), ("abc", "abc"),
                 ("abc", "xyz"), ("Vivek", "Vivek ")):
        assert tdedup._levenshtein_ratio(a, b) == \
            jdedup._levenshtein_ratio(a, b)


def random_graph_ops(seed, pages=12):
    """Pages over a small pool of entity ids per document (so entities
    MERGE across pages and move rows), relationships with self loops and
    repeated keys."""
    r = np.random.default_rng(seed)
    ops = []
    for i in range(pages):
        doc = f"d{i % 3}"
        ids = r.choice(10, size=5, replace=False)
        ents = [{"id": f"x{j}", "text": f"X {j}", "entity_type": "ORG",
                 "occurrences": int(r.integers(1, 4))} for j in ids]
        rels = []
        for _ in range(8):
            a, b = r.integers(0, 5, 2)  # a == b: a self loop
            rels.append({"source": ents[a]["id"], "target": ents[b]["id"],
                         "relation_type": ["USES", "OWNS"][int(a) % 2]})
        ops.append(("page", doc, int(r.integers(1, 3)), dict(
            content="c", embedding=unit(r, 1)[0], entities=ents,
            relationships=rels, entity_embeddings=unit(r, len(ents)),
            relationship_embeddings=unit(r, len(rels)))))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_merge_matches_reference_on_random_graphs(seed):
    """`merge_duplicates` (deferred list rewrites) against the
    reference's, on random graphs and random pairs: chains of merges,
    pairs between already merged or dead rows, winner-loser edges."""
    jkg, tkg = make_pair(ops=random_graph_ops(seed))
    assert host_state(tkg) == host_state(jkg)
    r = np.random.default_rng(100 + seed)
    n = jkg.spaces[JSpace.ENTITY].index.size
    pairs = [(int(a), int(b), 0.9) for a, b in r.integers(0, n, (3 * n, 2))
             if a != b]
    assert tdedup.merge_duplicates(tkg, pairs) == \
        jdedup.merge_duplicates(jkg, pairs) > 0
    assert host_state(tkg) == host_state(jkg)
    np.testing.assert_array_equal(
        tkg.spaces[Space.ENTITY].index.live.numpy(),
        np.asarray(jkg.spaces[JSpace.ENTITY].index.live))


@pytest.mark.parametrize("seed", range(2))
def test_merge_study_reference_method(seed):
    """`merge_study.reference_merge`, the reference's loop with a row ->
    keys map and one delete at the end, leaves the reference's state."""
    from rag_application_tpu_torch.kg.merge_study import reference_merge

    jkg, tkg = make_pair(ops=random_graph_ops(seed))
    r = np.random.default_rng(200 + seed)
    n = jkg.spaces[JSpace.ENTITY].index.size
    pairs = [(int(a), int(b), 0.9) for a, b in r.integers(0, n, (3 * n, 2))
             if a != b]
    merged, done = reference_merge(tkg, pairs, float("inf"))
    assert done and merged == jdedup.merge_duplicates(jkg, pairs) > 0
    assert host_state(tkg) == host_state(jkg)
    np.testing.assert_array_equal(
        tkg.spaces[Space.ENTITY].index.live.numpy(),
        np.asarray(jkg.spaces[JSpace.ENTITY].index.live))


def test_find_duplicates_query_blocks(monkeypatch):
    """The self-kNN in blocks of queries gives the one-block pairs."""
    jkg, tkg = make_pair(ops=dedup_ops())
    carry_tables(tkg, jkg)
    whole = tdedup.find_duplicates(tkg)
    monkeypatch.setattr(tdedup, "_KNN_TILE", 3 * 1024)  # 3 queries a block
    assert tdedup.find_duplicates(tkg) == whole


def test_dedup_loop_stops():
    _, tkg = make_pair(ops=dedup_ops())

    async def main():
        stop = asyncio.Event()
        task = asyncio.create_task(tdedup.deduplication_loop(
            tkg, interval=0.05, stop_event=stop))
        await asyncio.sleep(0.12)
        stop.set()
        return await asyncio.wait_for(task, timeout=30)

    assert asyncio.run(main()) >= 1


def test_extract_parses_stub_output():
    raw = {"entities": [
        {"id": "Ada Lovelace", "text": "Ada Lovelace",
         "entity_type": "PERSON", "entity_profile": "mathematician"},
        {"id": "ada_lovelace", "text": "Ada", "entity_type": "PERSON"},
        {"text": "Analytical Engine", "entity_type": "MACHINE"},
        {"id": "x", "text": ""}],
        "relationships": [
            {"source": "Ada Lovelace", "target": "analytical_engine",
             "relation_type": "CREATED", "confidence": 0.9},
            {"source": "ada_lovelace", "target": "analytical_engine",
             "relation_type": "INVENTED", "confidence": 0.0},
            {"source": "ada_lovelace", "target": "nobody",
             "relation_type": "USES"}]}
    outs = []
    for router_cls, provider, cls in ((JRouter, JProvider, JExtractor),
                                      (LLMRouter, Provider,
                                       EntityRelationExtractor)):
        llm = router_cls(provider.STUB)
        llm.stub.on(r"Extract the knowledge graph", lambda _: json.dumps(raw))
        ex = cls(llm, min_confidence=0.1)
        outs.append((asyncio.run(ex.extract("Ada built an engine.")),
                     asyncio.run(ex.extract_chunks(["One.", "two", "Three"])),
                     cls.merge_chunks(["A b.", "c d", "E f", "g"])))
    assert outs[0] == outs[1]
    assert [e["id"] for e in outs[1][0]["entities"]] == \
        ["ada_lovelace", "analytical_engine"]
    assert len(outs[1][0]["relationships"]) == 1


def assert_files_equal(a, b):
    for name in KG_FILES:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_kg_checkpoints_across_packages(tmp_path):
    jkg, tkg = make_pair()
    for kg in (jkg, tkg):
        kg.reset_document("c.pdf")  # tombstones in every space
    carry_tables(tkg, jkg)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    j_save_kg(jkg, jpath)
    save_kg(tkg, tpath)
    assert_files_equal(jpath, tpath)

    t_from_j = load_kg(jpath, KGConfig(max_degree=8), device="cpu")
    j_from_t = j_load_kg(tpath, JKGConfig(max_degree=8))
    assert t_from_j.stats() == j_from_t.stats() == jkg.stats()
    assert_tables_equal(t_from_j, j_from_t)
    assert_tables_equal(t_from_j, jkg)
    assert host_state(t_from_j)[:5] == host_state(jkg)[:5]
    assert host_state(j_from_t)[:5] == host_state(tkg)[:5]
    q = np.asarray(jkg.spaces[JSpace.ENTITY].index.vecs[2], dtype=np.float32)
    assert_hits_equal(t_from_j.search_across_spaces(q, k=8),
                      j_from_t.search_across_spaces(q, k=8))
    rows = [jkg._find_entity_row("a.pdf-p1-e0", "a.pdf")]
    assert compare_paths(t_from_j.traverse(rows, 3, query_embedding=q),
                         j_from_t.traverse(rows, 3, query_embedding=q),
                         beam_scores(jkg, q), 2 * DIM * 2.0 ** -24) == 0
    assert t_from_j.entity_context(rows[0]) == j_from_t.entity_context(rows[0])
    # the restored port store takes upserts like the original
    more = [op for op in operations(seed=2) if op[1] == "c.pdf"][:1]
    apply(t_from_j, more)
    apply(jkg, more)
    assert host_state(t_from_j)[:5] == host_state(jkg)[:5]
    assert t_from_j.stats() == jkg.stats()
