"""Parity of the port's sharded multi-space KG search (`parallel/kg.py`)
with the JAX package's, on the CPU: the port's `ShardedKGSearch` at
``make_mesh(8, devices=[cpu] * 8)`` against the reference's at
``make_mesh(8)``, over stores holding the same rows (the reference's
space tables carried into the port's `KGStore`, `tests/torch_carry.py`,
so both search equal planes). Each case of tests/test_kg_sharded.py has
its counterpart:

  * hits (space, row, payload) equal to the reference's, scores within
    1e-5; and equal to the port's own single-device
    `KGStore.search_across_spaces` / `search_space` (the same bf16
    products, so the same scores);
  * filters, deletes and `refresh()`;
  * capacity mode (int8 planes, per-row 1/||row||): hits and scores
    equal to the reference's, and the reference test's recall against
    the exact bf16 search;
  * the dry run.
"""

import numpy as np
import pytest
import torch

from rag_application_tpu.kg.store import KGStore as JKGStore
from rag_application_tpu.parallel.kg import ShardedKGSearch as JSharded
from rag_application_tpu.parallel.mesh import make_mesh as j_make_mesh
from rag_application_tpu_torch.kg.store import KGStore, Space
from rag_application_tpu_torch.parallel import kg as tkg
from rag_application_tpu_torch.parallel.mesh import make_mesh
from torch_carry import carry_kg

DIM = 64
CPU8 = [torch.device("cpu")] * 8


def _populate(store, rng, n_docs=6, pages_per_doc=8, ents_per_page=4):
    """tests/test_kg_sharded.py's multi-document store with entities,
    relationships and a sheet."""
    for d in range(n_docs):
        doc = f"doc{d}"
        for p in range(pages_per_doc):
            ents = [{"id": f"e{d}_{p}_{i}", "text": f"entity {d}{p}{i}",
                     "entity_type": "T", "entity_profile": "prof"}
                    for i in range(ents_per_page)]
            rels = [{"source": ents[0]["id"], "target": ents[1]["id"],
                     "relation_type": "R", "relationship_profile": "rp"}]
            store.upsert_unstructured_page(
                doc, p,
                content=f"page {d}:{p}",
                embedding=rng.standard_normal(DIM).astype(np.float32),
                entities=ents,
                entity_embeddings=rng.standard_normal(
                    (ents_per_page, DIM)).astype(np.float32),
                relationships=rels,
                relationship_embeddings=rng.standard_normal(
                    (1, DIM)).astype(np.float32),
            )
    store.upsert_structured_sheet(
        "doc0", 99, sheet_name="s", summary="sheet summary",
        summary_embedding=rng.standard_normal(DIM).astype(np.float32),
        columns=[{"name": "a"}, {"name": "b"}],
        column_embeddings=rng.standard_normal((2, DIM)).astype(np.float32),
        rows=[{"a": 1, "b": 2}],
    )


def stores(seed, **kw):
    """(JAX KGStore, port KGStore on the CPU) with the same rows: the same
    upserts into both, then the reference's tables carried over."""
    jstore, tstore = JKGStore(dim=DIM), KGStore(dim=DIM, device="cpu")
    _populate(jstore, np.random.default_rng(seed), **kw)
    _populate(tstore, np.random.default_rng(seed), **kw)
    carry_kg(jstore, tstore)
    return jstore, tstore


def key(hits):
    return [(h["space"], h["row"], h.get("id"), h.get("document_id"))
            for h in hits]


def assert_same_hits(got, want, atol=1e-5):
    assert key(got) == key(want)
    np.testing.assert_allclose([h["score"] for h in got],
                               [h["score"] for h in want], rtol=0,
                               atol=atol)


@pytest.mark.parametrize("capacity", [False, True])
def test_sharded_equals_reference_and_single_device(capacity):
    jstore, tstore = stores(0)
    jsh = JSharded(jstore, j_make_mesh(8), capacity=capacity)
    tsh = tkg.ShardedKGSearch(tstore, make_mesh(8, devices=CPU8),
                              capacity=capacity)
    for seed in range(4):
        q = np.random.default_rng(seed).standard_normal(DIM)
        multi = tsh.search_across_spaces(q, k=10)
        assert_same_hits(multi, jsh.search_across_spaces(q, k=10))
        for space in (Space.ENTITY, Space.PAGE):
            assert_same_hits(tsh.search_space(space, q, k=5),
                             jsh.search_space(space, q, k=5))
        if not capacity:
            # the port's own single-device search: the same bf16 products
            assert_same_hits(multi, tstore.search_across_spaces(q, k=10),
                             atol=0)
            assert [h["row"] for h in tsh.search_space(Space.ENTITY, q, 5)] \
                == [h["row"] for h in tstore.search_space(Space.ENTITY, q, 5)]


def test_sharded_filters_and_refresh():
    jstore, tstore = stores(1, n_docs=3)
    jsh = JSharded(jstore, j_make_mesh(8))
    tsh = tkg.ShardedKGSearch(tstore, make_mesh(8, devices=CPU8))
    q = np.random.default_rng(5).standard_normal(DIM)
    hits = tsh.search_across_spaces(q, k=8, document_id="doc1")
    assert_same_hits(hits, jsh.search_across_spaces(q, k=8,
                                                    document_id="doc1"))
    assert hits and all(h["document_id"] == "doc1" for h in hits)
    # deletes are invisible until refresh(), then excluded
    jstore.delete_document("doc1")
    tstore.delete_document("doc1")
    stale = tsh.search_across_spaces(q, k=8, document_id="doc1")
    assert key(stale) == key(jsh.search_across_spaces(q, k=8,
                                                      document_id="doc1"))
    jsh.refresh()
    tsh.refresh()
    assert tsh.search_across_spaces(q, k=8, document_id="doc1") == []
    other = tsh.search_across_spaces(q, k=8)
    assert_same_hits(other, jsh.search_across_spaces(q, k=8))
    assert other and all(h["document_id"] != "doc1" for h in other)


def test_capacity_mode_recall():
    """int8-plane sharded search: top-k overlaps the exact bf16 search
    (the int8 storage floor), as the reference test holds."""
    _, tstore = stores(2, n_docs=8, pages_per_doc=8)
    cap = tkg.ShardedKGSearch(tstore, make_mesh(8, devices=CPU8),
                              capacity=True)
    for seed in range(3):
        q = np.random.default_rng(100 + seed).standard_normal(DIM)
        exact = {(h["space"], h["row"])
                 for h in tstore.search_across_spaces(q, k=10)}
        got = {(h["space"], h["row"])
               for h in cap.search_across_spaces(q, k=10)}
        assert len(exact & got) >= 8


def test_build_sharded_kg_matches_reference():
    from rag_application_tpu.parallel.kg import build_sharded_kg as jbuild

    jstore, tstore = stores(3, n_docs=2)
    for capacity in (False, True):
        want = jbuild(jstore, 8, capacity=capacity)
        got = tkg.build_sharded_kg(tstore, 8, capacity=capacity)
        assert {s.value for s in got["spaces"]} == \
            {s.value for s in want["spaces"]}
        for s, t in got["spaces"].items():
            w = next(v for k, v in want["spaces"].items()
                     if k.value == s.value)
            assert (t["size"], t["rps"]) == (w["size"], w["rps"])
            np.testing.assert_array_equal(t["live"].numpy(), w["live"])
            plane = t["plane"]
            if plane.dtype == torch.bfloat16:
                plane = plane.float()
            np.testing.assert_array_equal(
                plane.numpy(), np.asarray(w["plane"], dtype=plane.numpy().dtype))
            if capacity:
                np.testing.assert_array_equal(t["recip"].numpy(), w["recip"])


def test_dryrun_runs():
    tkg.sharded_kg_dryrun(make_mesh(8, devices=CPU8))
