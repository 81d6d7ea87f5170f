"""Knowledge-search toolbox: 21 tools over the native index + graph.

Port of `rag_application_tpu/tools/knowledge.py`, over the port's
`Collection`, `KGStore` and `Embedder`: `hybrid_search` runs the fused
funnel (the scan and BM25 match kernels on the card), and
`path_between_entities` hands `ops/graph_hop.py::path_first_hop`
tensors on the KG's device. The rest is the reference's code.

Parity: the reference's 21 LangChain tools (AgentAPI/app/tools/core_tools/
knowledge_search/knowledge_search_tool.py:425-1456) wrapping the 20
`execute_*` query functions (AgentAPI/app/core/knowledge_search/
queries.py:80-672). Where the reference issues Cypher over HTTP to the
IndexerAPI graph, these tools call the framework's own stores directly:
Collection (chunk index: hybrid dense+BM25 search) and KGStore (pages,
entities, relationships, columns, traversal). The raw-Cypher passthrough
becomes `structured_query` — a typed query surface with the same
user/org guardrails the reference enforces on raw Cypher
(queries.py:11-22,460-470).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kg.store import KGStore, Space
from ..store.collection import Collection
from .registry import Tool, ToolRegistry


def _q(schema_props: Dict[str, Any], required: List[str]) -> Dict[str, Any]:
    return {"type": "object", "properties": schema_props, "required": required}

_QUERY = _q({"query": {"type": "string"},
             "k": {"type": "integer", "default": 5}}, ["query"])
_DOC = _q({"document_id": {"type": "string"}}, ["document_id"])


class KnowledgeSearchToolbox:
    """Builds the toolbox bound to one (collection, kg, embedder) triple."""

    def __init__(self, collection: Collection, kg: KGStore, embedder):
        self.col = collection
        self.kg = kg
        self.embedder = embedder

    def _embed(self, text: str, dim: Optional[int] = None) -> np.ndarray:
        v = self.embedder.encode([text])[0]
        if dim is not None:
            v = v[:dim] if len(v) >= dim else np.pad(v, (0, dim - len(v)))
        return v

    def _space_search(self, space: Space, query: str, k: int, **filters):
        return self.kg.search_space(
            space, self._embed(query, self.kg.dim), k=k, **filters)

    # --------------------------------------------------------------- tools

    def build(self) -> ToolRegistry:
        reg = ToolRegistry()
        add = reg.add
        col, kg = self.col, self.kg

        # 1 — document catalogue search (execute_search_documents)
        def search_documents(query: str, k: int = 5):
            q = query.lower()
            hits = [dict(meta, document_id=doc_id)
                    for doc_id, meta in kg.documents.items()
                    if q in doc_id.lower()
                    or q in json.dumps(meta, default=str).lower()]
            return hits[:k]
        add(Tool("search_documents", "Find documents by name or metadata.",
                 _QUERY, search_documents))

        # 2 — list all documents (execute_get_documents)
        add(Tool("list_documents", "List all indexed documents.",
                 _q({}, []), lambda: [
                     dict(meta, document_id=d) for d, meta in
                     kg.documents.items()]))

        # 3 — document metadata (execute_get_document_metadata)
        add(Tool("get_document_metadata", "Get one document's metadata.",
                 _DOC, lambda document_id: kg.get_document(document_id) or
                 {"error": "not found"}))

        # 4 — pages of a document (execute_get_document_pages)
        add(Tool("list_document_pages",
                 "List a document's pages with content snippets.",
                 _DOC, lambda document_id: [
                     {**p, "content": str(p.get("content", ""))[:400]}
                     for p in kg.get_pages(document_id)]))

        # 5 — one page (execute_get_page_content)
        def get_page_content(document_id: str, page_number: int):
            for p in kg.get_pages(document_id):
                if p.get("page_number") == page_number:
                    return p
            return {"error": "page not found"}
        add(Tool("get_page_content", "Fetch one page's full content.",
                 _q({"document_id": {"type": "string"},
                     "page_number": {"type": "integer"}},
                    ["document_id", "page_number"]), get_page_content))

        # 6-9 — semantic kNN per space (execute_semantic_search_*)
        for space, name, desc in (
            (Space.PAGE, "search_pages_semantic",
             "Semantic search over page embeddings."),
            (Space.ENTITY, "search_entities_semantic",
             "Semantic search over entity profiles."),
            (Space.RELATIONSHIP, "search_relationships_semantic",
             "Semantic search over relationship profiles."),
            (Space.COLUMN, "search_columns_semantic",
             "Semantic search over table-column profiles."),
        ):
            add(Tool(name, desc, _QUERY,
                     (lambda s: lambda query, k=5:
                      self._space_search(s, query, k))(space)))

        # 10 — multi-space scout (search_across_spaces / execute_hybrid_search)
        add(Tool("search_across_spaces",
                 "Semantic search across pages, entities, relationships and "
                 "columns at once, merged by score.",
                 _QUERY, lambda query, k=10: kg.search_across_spaces(
                     self._embed(query, kg.dim), k=k)))

        # 11 — chunk-level hybrid retrieval (the v1 hybrid_search funnel)
        def hybrid_search(query: str, k: int = 5):
            hits = col.hybrid_search(self._embed(query), query, limit=k)
            return [{"score": h.score,
                     "text": str(h.payload.get("text", ""))[:500],
                     "document_id": h.payload.get("document_id"),
                     "chunk_index": h.payload.get("chunk_index")}
                    for h in hits]
        add(Tool("hybrid_search",
                 "Hybrid dense+keyword retrieval over document chunks with "
                 "rank fusion.", _QUERY, hybrid_search))

        # 12 — entity lookup by id (execute_get_entity)
        def get_entity_by_id(entity_id: str, document_id: str = ""):
            table = kg.spaces[Space.ENTITY]
            for _key, row in table.rows_for_id(entity_id, document_id):
                p = table.get(row)
                if p:
                    return p
            return {"error": "not found"}
        add(Tool("get_entity_by_id", "Fetch an entity by its id.",
                 _q({"entity_id": {"type": "string"},
                     "document_id": {"type": "string", "default": ""}},
                    ["entity_id"]), get_entity_by_id))

        # 13 — entities by type (execute_find_entities_by_type)
        def find_entities_by_type(entity_type: str, k: int = 20):
            return [e for e in kg.get_entities()
                    if e.get("entity_type") == entity_type][:k]
        add(Tool("find_entities_by_type", "List entities of a given type.",
                 _q({"entity_type": {"type": "string"},
                     "k": {"type": "integer", "default": 20}},
                    ["entity_type"]), find_entities_by_type))

        # 14 — entity context join (execute_get_entity_context)
        def get_entity_context(entity_id: str, document_id: str = ""):
            table = kg.spaces[Space.ENTITY]
            for _key, row in table.rows_for_id(entity_id, document_id):
                return kg.entity_context(row)
            return {"error": "not found"}
        add(Tool("get_entity_context",
                 "An entity with its relationships and neighbors.",
                 _q({"entity_id": {"type": "string"},
                     "document_id": {"type": "string", "default": ""}},
                    ["entity_id"]), get_entity_context))

        # 15 — k-hop traversal (execute_traverse_entity_graph, <=3 hops)
        def traverse_entity_graph(entity_id: str, hops: int = 2,
                                  query: str = ""):
            table = kg.spaces[Space.ENTITY]
            rows = [row for _key, row in table.rows_for_id(entity_id)]
            if not rows:
                return {"error": "not found"}
            qe = self._embed(query, kg.dim) if query else None
            return kg.traverse(rows[:1], hops, query_embedding=qe)[0]
        add(Tool("traverse_entity_graph",
                 "Expand an entity's neighborhood up to 3 hops, optionally "
                 "relevance-pruned by a query.",
                 _q({"entity_id": {"type": "string"},
                     "hops": {"type": "integer", "default": 2},
                     "query": {"type": "string", "default": ""}},
                    ["entity_id"]), traverse_entity_graph))

        # 16 — BFS between entities (execute_bfs)
        def path_between_entities(source_id: str, target_id: str,
                                  max_hops: int = 3):
            table = kg.spaces[Space.ENTITY]
            src = [r for _k, r in table.rows_for_id(source_id)]
            dst = [r for _k, r in table.rows_for_id(target_id)]
            if not src or not dst:
                return {"error": "entity not found"}
            # exact dense-frontier reachability (the reference's
            # execute_bfs is exact BFS <= 3 hops): the beam-pruned
            # traverse could drop the target at hub nodes with more than
            # frontier_cap neighbors
            adj, _n = kg.entity_adjacency()
            hops_cap = min(max_hops, kg.cfg.max_hops)
            # one dispatch finds the FIRST reaching hop (a loop of
            # path_reachability calls compiled one variant per h and
            # re-walked lower hops each time)
            from ..ops.graph_hop import path_first_hop

            def ids(rows):
                return torch.tensor(rows, dtype=torch.int32,
                                    device=adj.device)

            h = int(path_first_hop(adj, ids(src[:1]), ids(dst[:1]),
                                   hops_cap)[0])
            if h >= 0:
                return {"reachable": True, "hops": max(h, 1)}
            return {"reachable": False, "hops": None}
        add(Tool("path_between_entities",
                 "Whether and how far two entities connect (<= 3 hops).",
                 _q({"source_id": {"type": "string"},
                     "target_id": {"type": "string"},
                     "max_hops": {"type": "integer", "default": 3}},
                    ["source_id", "target_id"]), path_between_entities))

        # 17 — relationships between two entities (execute_get_relationships)
        def get_relationships_between(source_id: str, target_id: str):
            table = kg.spaces[Space.ENTITY]
            rel_t = kg.spaces[Space.RELATIONSHIP]
            out = []
            for _key, row in table.rows_for_id(source_id):
                for rel_row, other in kg.entity_edges.get(row, []):
                    op = table.get(other)
                    if op and op.get("id") == target_id:
                        rp = rel_t.get(rel_row)
                        if rp:
                            out.append(rp)
            return out
        add(Tool("get_relationships_between",
                 "All relationships linking two entities.",
                 _q({"source_id": {"type": "string"},
                     "target_id": {"type": "string"}},
                    ["source_id", "target_id"]), get_relationships_between))

        # 18 — column values (execute_get_column_values / row values)
        def get_column_values(column_name: str, sheet_name: str = "",
                              k: int = 50):
            table = kg.spaces[Space.COLUMN]
            for key, row in table.by_key.items():
                if key[2] == column_name and (not sheet_name or key[1] == sheet_name):
                    vals = kg.column_values.get(row, [])
                    return {"column": table.get(row), "values": vals[:k]}
            return {"error": "column not found"}
        add(Tool("get_column_values", "Values stored under a table column.",
                 _q({"column_name": {"type": "string"},
                     "sheet_name": {"type": "string", "default": ""},
                     "k": {"type": "integer", "default": 50}},
                    ["column_name"]), get_column_values))

        # 19 — row-value search (execute_search_row_values)
        def search_row_values(value: str, k: int = 20):
            out = []
            vq = value.lower()
            col_t = kg.spaces[Space.COLUMN]
            for row, vals in kg.column_values.items():
                for v in vals:
                    if vq in str(v.get("value", "")).lower():
                        out.append({"column": col_t.get(row), "match": v})
                        if len(out) >= k:
                            return out
            return out
        add(Tool("search_row_values", "Find table cells containing a value.",
                 _q({"value": {"type": "string"},
                     "k": {"type": "integer", "default": 20}}, ["value"]),
                 search_row_values))

        # 20 — chunk neighborhood (execute_get_chunk_neighbors: the ±context
        # join the v1 pipeline stores)
        def get_chunk_neighbors(document_id: str, chunk_index: int,
                                radius: int = 2):
            rows = col.payloads.rows_where(document_id=document_id)
            out = []
            for r in rows:
                p = col.payloads.get(r)
                if p and abs(p.get("chunk_index", -10**9) - chunk_index) <= radius:
                    out.append({"chunk_index": p.get("chunk_index"),
                                "text": str(p.get("text", ""))[:400]})
            return sorted(out, key=lambda x: x["chunk_index"] or 0)
        add(Tool("get_chunk_neighbors",
                 "Neighboring chunks around a chunk (context window).",
                 _q({"document_id": {"type": "string"},
                     "chunk_index": {"type": "integer"},
                     "radius": {"type": "integer", "default": 2}},
                    ["document_id", "chunk_index"]), get_chunk_neighbors))

        # 21 — typed structured query (replaces raw-Cypher passthrough with
        # the same guardrail intent: no arbitrary graph mutations, scope
        # enforced by the store itself)
        def structured_query(operation: str, args: str = "{}"):
            ops = {
                "stats": lambda **_: kg.stats(),
                "chunk_count": lambda **_: col.chunk_count(),
                "entities_of_document": lambda document_id="", **_:
                    kg.get_entities(document_id or None),
                "documents": lambda **_: list(kg.documents),
            }
            fn = ops.get(operation)
            if fn is None:
                return {"error": f"unknown operation; available: {sorted(ops)}"}
            try:
                return fn(**json.loads(args or "{}"))
            except (TypeError, json.JSONDecodeError) as e:
                return {"error": str(e)}
        add(Tool("structured_query",
                 "Typed graph queries: stats | chunk_count | "
                 "entities_of_document | documents.",
                 _q({"operation": {"type": "string"},
                     "args": {"type": "string", "default": "{}"}},
                    ["operation"]), structured_query))

        return reg
