"""Knowledge-graph store: typed graph + 4 embedded vector spaces.

Port of `rag_application_tpu/kg/store.py`. The spaces are the port's
`DenseIndex` (every upsert is one `DenseIndex.insert`, so one launch of
the prep kernel, `csrc/prep_vectors.cu`, at the store's width with no
matryoshka dims); the padded adjacency lives on the store's device and
the hop expansion is `ops.graph_hop.k_hop_expand`. One change from the
reference, with the same result: the end of a page upsert drops the edge
pairs of tombstoned relationship rows only when some relationship row was
tombstoned since the last such pass (the reference walks every edge on
every upsert, which grows quadratically with the graph).

Replaces the reference's Neo4j unified index (IndexerAPI/src/core/
storage/neo4j_handler.py) — THE index of v2:

  graph schema (:49-97):
    Document -HAS_PAGE-> Page -MENTIONS-> Entity -RELATIONSHIP-> Entity
    Page -MENTIONS-> Column -HAS_VALUE-> RowValue -RELATES_TO-> RowValue
  vector indexes: page / entity / column / relationship embeddings,
    cosine, EMBEDDING_DIMENSIONS (2048 in v2; v1 uses 256-d entity
    vectors, app/core/graph_db/neo4j/neo4j_handler.py:36-58)

Here each embedded space is a DenseIndex shard on the device; graph
structure lives in host dicts mirrored to a padded device adjacency for
the traversal. Upserts keep the reference's transactional semantics:
`upsert_*_page` deletes the page's prior subgraph first (page-level
replace, :154-203), `reset_document`/`delete_document` cascade
(:99-152), entity/relationship MERGE is keyed (id, document_id)
(:741-795). Multi-space search = the 4 kNN scans issued before any
result is read back + score-sorted merge (parity: `search_across_spaces`,
:809-827).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import IndexConfig, KGConfig
from ..index.dense import DenseIndex
from ..store.collection import mutator
from ..utils import DeviceLike, full_f32_matmul, resolve_device

# entity rows a block in the traversal's beam scores (bounds the f32
# transient of the bf16 rows)
_SCORE_ROWS = 65536


class Space(str, enum.Enum):
    PAGE = "page"
    ENTITY = "entity"
    COLUMN = "column"
    RELATIONSHIP = "relationship"


@dataclass
class _SpaceTable:
    """One embedded space: a DenseIndex plus row-aligned payloads."""

    index: DenseIndex
    payloads: List[Optional[Dict[str, Any]]] = field(default_factory=list)
    # (key) -> row for MERGE semantics
    by_key: Dict[Tuple, int] = field(default_factory=dict)
    # secondary index on key[1] (entity_id for the ENTITY space) so id
    # lookups are O(matches), not O(N) scans of by_key — the reference
    # gets this from Neo4j's b-tree index on Entity.id
    # (IndexerAPI/src/core/storage/neo4j_handler.py:67-97)
    by_id: Dict[Any, Dict[Tuple, int]] = field(default_factory=dict)
    # rows tombstoned so far (MERGE re-upserts and deletes)
    tombstones: int = 0

    def upsert(self, key: Tuple, payload: Dict[str, Any],
               embedding: np.ndarray) -> int:
        row = self.by_key.get(key)
        if row is not None:
            # MERGE: tombstone the old row, append the new version
            self.index.delete([row])
            self.payloads[row] = None
            self.tombstones += 1
        new_row = int(self.index.insert(np.asarray(embedding)[None, :])[0])
        while len(self.payloads) <= new_row:
            self.payloads.append(None)
        self.payloads[new_row] = dict(payload)
        self.by_key[key] = new_row
        self.by_id.setdefault(key[1], {})[key] = new_row
        return new_row

    def delete_key(self, key: Tuple) -> Optional[int]:
        row = self.by_key.pop(key, None)
        if row is not None:
            self.index.delete([row])
            self.payloads[row] = None
            self.tombstones += 1
            group = self.by_id.get(key[1])
            if group is not None:
                group.pop(key, None)
                if not group:
                    del self.by_id[key[1]]
        return row

    def rows_for_id(self, ident: Any,
                    document_id: str = "") -> List[Tuple[Tuple, int]]:
        """All (key, row) pairs whose key[1] == ident, optionally filtered
        by trailing document_id — the O(1)-ish replacement for scanning
        by_key."""
        group = self.by_id.get(ident)
        if not group:
            return []
        items = list(group.items())
        if document_id:
            items = [(k, r) for k, r in items if k[-1] == document_id]
        return items

    def get(self, row: int) -> Optional[Dict[str, Any]]:
        if 0 <= row < len(self.payloads):
            return self.payloads[row]
        return None


class KGStore:
    def __init__(self, config: Optional[KGConfig] = None, *, dim: int = 2048,
                 scope: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        """`dim` is EMBEDDING_DIMENSIONS (2048 v2 parity; 256 for the v1 KG).

        `scope` carries user_id/org_id the way the reference scopes every
        node (neo4j_handler.py MATCH clauses on user_id/org_id).
        """
        self.cfg = config or KGConfig()
        self.device = resolve_device(device)
        self.lock = threading.RLock()
        self.dim = dim
        self.scope = scope or {}
        icfg = IndexConfig(dim=dim, matryoshka_dims=(), initial_capacity=1024,
                           block_size=65536)
        self.spaces: Dict[Space, _SpaceTable] = {
            s: _SpaceTable(DenseIndex(icfg, device=self.device))
            for s in Space
        }
        # documents/pages are metadata-only (no vectors for Document; Page
        # rows live in the PAGE space)
        self.documents: Dict[str, Dict[str, Any]] = {}
        # document_id -> {page_number -> page row}
        self.doc_pages: Dict[str, Dict[int, int]] = {}
        # entity adjacency: entity row -> list of (rel row, other entity row)
        self.entity_edges: Dict[int, List[Tuple[int, int]]] = {}
        # page row -> entity rows mentioned
        self.page_mentions: Dict[int, List[int]] = {}
        # column row -> row-value payload list (values are not embedded in
        # the reference either; RowValue vectors exist only via columns)
        self.column_values: Dict[int, List[Dict[str, Any]]] = {}
        # page row -> [(column key, column row)] for page-replace cleanup
        self.page_columns: Dict[int, List[Tuple[Tuple, int]]] = {}
        self._adj_cache: Optional[Tuple[torch.Tensor, int]] = None
        # the relationship space's tombstone count at the last pass that
        # dropped edge pairs of tombstoned relationship rows
        self._rels_pruned_at = 0

    # ------------------------------------------------------------ documents

    @mutator
    def upsert_document(self, document_id: str, metadata: Dict[str, Any]) -> None:
        meta = dict(metadata)
        meta.update(self.scope)
        self.documents[document_id] = meta
        self.doc_pages.setdefault(document_id, {})

    @mutator
    def reset_document(self, document_id: str) -> int:
        """Delete every node hanging off a document (parity:
        reset_document, neo4j_handler.py:99-152). Idempotent."""
        removed = 0
        pages = self.doc_pages.pop(document_id, {})
        for page_no, page_row in pages.items():
            removed += self._delete_page_subgraph(document_id, page_no, page_row)
        # document-scoped entities/relationships
        for space in (Space.ENTITY, Space.RELATIONSHIP, Space.COLUMN):
            table = self.spaces[space]
            doomed = [k for k in table.by_key if k[-1] == document_id]
            for k in doomed:
                row = table.delete_key(k)
                removed += row is not None
                if space is Space.ENTITY and row is not None:
                    self.entity_edges.pop(row, None)
                if space is Space.COLUMN and row is not None:
                    self.column_values.pop(row, None)
        self.documents.pop(document_id, None)
        self.doc_pages[document_id] = {}
        self._adj_cache = None
        return removed

    @mutator
    def delete_document(self, document_id: str) -> int:
        removed = self.reset_document(document_id)
        self.doc_pages.pop(document_id, None)
        return removed

    def _delete_page_subgraph(self, document_id: str, page_no: int,
                              page_row: int) -> int:
        table = self.spaces[Space.PAGE]
        table.delete_key(("page", document_id, page_no))
        self.page_mentions.pop(page_row, None)
        # a structured sheet's columns belong to the page: replace-upsert
        # must delete them (a dropped column would otherwise stay
        # searchable forever) and their values (keyed by now-dead rows)
        for key, col_row in self.page_columns.pop(page_row, []):
            self.spaces[Space.COLUMN].delete_key(key)
            self.column_values.pop(col_row, None)
        return 1

    # --------------------------------------------------------------- pages

    @mutator
    def upsert_unstructured_page(
        self,
        document_id: str,
        page_number: int,
        *,
        content: str,
        image_s3_url: Optional[str] = None,
        embedding: np.ndarray,
        entities: Sequence[Dict[str, Any]] = (),
        relationships: Sequence[Dict[str, Any]] = (),
        entity_embeddings: Optional[np.ndarray] = None,
        relationship_embeddings: Optional[np.ndarray] = None,
    ) -> int:
        """Page-level replace upsert (parity: upsert_unstructured_page,
        neo4j_handler.py:154-203 + entity/rel MERGE :741-795).

        entities: dicts with at least {"id", "text", "entity_type",
        "entity_profile"}; relationships with {"source", "target",
        "relation_type", "relationship_profile"} (ModelHandler
        EntityRelationSchema, IndexerAPI model_handler.py:28).
        """
        self.upsert_document(document_id, self.documents.get(document_id, {}))
        old = self.doc_pages[document_id].pop(page_number, None)
        if old is not None:
            self._delete_page_subgraph(document_id, page_number, old)

        page_payload = {
            "document_id": document_id,
            "page_number": page_number,
            "content": content,
            "image_s3_url": image_s3_url,
            **self.scope,
        }
        page_row = self.spaces[Space.PAGE].upsert(
            ("page", document_id, page_number), page_payload, embedding
        )
        self.doc_pages[document_id][page_number] = page_row

        ent_rows: Dict[str, int] = {}
        for i, ent in enumerate(entities):
            emb = (entity_embeddings[i] if entity_embeddings is not None
                   else np.zeros(self.dim, dtype=np.float32))
            key = ("entity", ent["id"], document_id)
            payload = {**ent, "document_id": document_id, **self.scope}
            old_row = self.spaces[Space.ENTITY].by_key.get(key)
            row = self.spaces[Space.ENTITY].upsert(key, payload, emb)
            if old_row is not None and old_row != row:
                # MERGE re-upsert moves the entity to a new row: carry its
                # graph along — edges from earlier pages must survive
                # (they referenced the now-tombstoned row)
                self._migrate_entity_row(old_row, row)
            self.entity_edges.setdefault(row, [])
            ent_rows[ent["id"]] = row
        self.page_mentions[page_row] = list(ent_rows.values())

        for i, rel in enumerate(relationships):
            emb = (relationship_embeddings[i]
                   if relationship_embeddings is not None
                   else np.zeros(self.dim, dtype=np.float32))
            key = ("rel", rel["source"], rel["target"],
                   rel.get("relation_type", ""), document_id)
            payload = {**rel, "document_id": document_id, **self.scope}
            rel_row = self.spaces[Space.RELATIONSHIP].upsert(key, payload, emb)
            src = ent_rows.get(rel["source"])
            dst = ent_rows.get(rel["target"])
            if src is None:
                src = self._find_entity_row(rel["source"], document_id)
            if dst is None:
                dst = self._find_entity_row(rel["target"], document_id)
            if src is not None and dst is not None:
                self.entity_edges.setdefault(src, []).append((rel_row, dst))
                self.entity_edges.setdefault(dst, []).append((rel_row, src))
        # prune edge pairs whose relationship row was tombstoned (by a
        # MERGE re-upsert above, or a delete since the last pass): the
        # fresh pair replaces them, and stale pairs would otherwise
        # accumulate per re-ingest until they crowd real neighbors out of
        # the max_degree adjacency window. With no relationship row
        # tombstoned since the last pass, every pair is live already.
        rel_table = self.spaces[Space.RELATIONSHIP]
        if rel_table.tombstones != self._rels_pruned_at:
            live = set(rel_table.by_key.values())
            for erow, lst in self.entity_edges.items():
                if any(r not in live for r, _ in lst):
                    self.entity_edges[erow] = [(r, o) for r, o in lst
                                               if r in live]
            self._rels_pruned_at = rel_table.tombstones
        self._adj_cache = None
        return page_row

    def _find_entity_row(self, entity_id: str, document_id: str) -> Optional[int]:
        return self.spaces[Space.ENTITY].by_key.get(
            ("entity", entity_id, document_id)
        )

    def _migrate_entity_row(self, old_row: int, new_row: int) -> None:
        """Rewrite every graph reference from a tombstoned entity row to
        its replacement (edge lists, neighbors' back-edges, mentions)."""
        edges = [(r, new_row if o == old_row else o)  # keep self-edges valid
                 for r, o in self.entity_edges.pop(old_row, [])]
        self.entity_edges[new_row] = edges
        for rel_row, other in edges:
            lst = self.entity_edges.get(other)
            if lst:
                self.entity_edges[other] = [
                    (r, new_row if o == old_row else o) for r, o in lst]
        for page, mentions in self.page_mentions.items():
            if old_row in mentions:
                self.page_mentions[page] = [
                    new_row if m == old_row else m for m in mentions]
        self._adj_cache = None

    # ----------------------------------------------------- structured sheets

    @mutator
    def upsert_structured_sheet(
        self,
        document_id: str,
        page_number: int,
        *,
        sheet_name: str,
        summary: str,
        summary_embedding: np.ndarray,
        columns: Sequence[Dict[str, Any]] = (),
        column_embeddings: Optional[np.ndarray] = None,
        rows: Sequence[Dict[str, Any]] = (),
    ) -> int:
        """Structured-sheet upsert (parity: upsert_structured_sheet,
        neo4j_handler.py:296-338 — Page + Column nodes with embeddings +
        RowValue nodes linked same-row)."""
        page_row = self.upsert_unstructured_page(
            document_id, page_number, content=summary,
            embedding=summary_embedding,
        )
        self.spaces[Space.PAGE].payloads[page_row]["sheet_name"] = sheet_name
        col_rows = []
        self.page_columns[page_row] = []
        for i, col in enumerate(columns):
            emb = (column_embeddings[i] if column_embeddings is not None
                   else np.zeros(self.dim, dtype=np.float32))
            key = ("column", sheet_name, col["name"], document_id)
            payload = {**col, "document_id": document_id,
                       "sheet_name": sheet_name, **self.scope}
            old_row = self.spaces[Space.COLUMN].by_key.get(key)
            row = self.spaces[Space.COLUMN].upsert(key, payload, emb)
            if old_row is not None and old_row != row:
                self.column_values.pop(old_row, None)  # re-upsert moved it
            self.column_values[row] = []
            col_rows.append(row)
            self.page_columns[page_row].append((key, row))
        for r in rows:
            for cr, col in zip(col_rows, columns):
                name = col["name"]
                if name in r:
                    self.column_values[cr].append(
                        {"row_index": r.get("_row", len(self.column_values[cr])),
                         "value": r[name]}
                    )
        return page_row

    # --------------------------------------------------------------- reads

    def get_document(self, document_id: str) -> Optional[Dict[str, Any]]:
        return self.documents.get(document_id)

    def get_pages(self, document_id: str) -> List[Dict[str, Any]]:
        rows = self.doc_pages.get(document_id, {})
        table = self.spaces[Space.PAGE]
        return [table.get(r) for _, r in sorted(rows.items())
                if table.get(r) is not None]

    def get_entities(self, document_id: Optional[str] = None) -> List[Dict[str, Any]]:
        table = self.spaces[Space.ENTITY]
        out = []
        with self.lock:  # readers may run in worker threads (see
            items = list(table.by_key.items())  # entity_adjacency)
        for key, row in items:
            if document_id is None or key[-1] == document_id:
                p = table.get(row)
                if p is not None:
                    out.append(p)
        return out

    def stats(self) -> Dict[str, int]:
        return {
            "documents": len(self.documents),
            **{s.value: int(t.index.live.sum().item())
               for s, t in self.spaces.items()},
        }

    # ---------------------------------------------------------- search API

    def _dispatch_space(self, space: Space, q: np.ndarray, k: int):
        """Issue one space's kNN without reading it back (device tensors)."""
        table = self.spaces[space]
        if table.index.size == 0:
            return None
        return table.index.search(q, min(k, table.index.size))

    def _materialize_space(self, space: Space, handle, k: int,
                           filters: Dict[str, Any]) -> List[Dict[str, Any]]:
        if handle is None:
            return []
        vals, ids = handle
        table = self.spaces[space]
        out = []
        for score, row in zip(vals[0].cpu().numpy(), ids[0].cpu().numpy()):
            if not np.isfinite(score):
                continue
            p = table.get(int(row))
            if p is None:
                continue
            if any(p.get(f) != v for f, v in filters.items()):
                continue
            out.append({"space": space.value, "score": float(score),
                        "row": int(row), **p})
        return out[:k]

    def search_space(self, space: Space, query_embedding, k: int = 10,
                     **filters) -> List[Dict[str, Any]]:
        """Per-space kNN (parity: the per-space `_search_*` helpers,
        neo4j_handler.py:829-1047)."""
        q = np.asarray(query_embedding, dtype=np.float32)[None, :]
        return self._materialize_space(
            space, self._dispatch_space(space, q, k), k, filters)

    def search_across_spaces(self, query_embedding, k: int = 10,
                             spaces: Optional[Sequence[Space]] = None,
                             **filters) -> List[Dict[str, Any]]:
        """Multi-space kNN, merged + sorted by score (parity:
        search_across_spaces, neo4j_handler.py:809-827). All spaces are
        dispatched before any result is read back, so the device (and a
        remote attach's round-trips) pipeline the per-space queries the
        way the reference's 4 parallel Cypher calls do."""
        spaces = list(spaces or Space)
        q = np.asarray(query_embedding, dtype=np.float32)[None, :]
        handles = [(s, self._dispatch_space(s, q, k)) for s in spaces]
        merged: List[Dict[str, Any]] = []
        for s, h in handles:
            merged.extend(self._materialize_space(s, h, k, filters))
        merged.sort(key=lambda h: -h["score"])
        return merged[:k]

    # ---------------------------------------------------------- traversal

    def entity_adjacency(self) -> Tuple[torch.Tensor, int]:
        """Padded device adjacency over entity rows for the hop kernels.

        Takes the store's mutation lock for the dict walk: readers run
        in worker threads (orchestration's graph branch uses to_thread)
        while @mutator writers mutate entity_edges on the event loop —
        an unlocked iteration can raise 'dictionary changed size' or
        capture a half-applied upsert."""
        with self.lock:
            if self._adj_cache is not None:
                return self._adj_cache
            n = self.spaces[Space.ENTITY].index.size
            deg = self.cfg.max_degree
            adj = np.full((n + 1, deg), n, dtype=np.int32)
            for row, edges in self.entity_edges.items():
                if row >= n:
                    continue
                for j, (_, other) in enumerate(edges[:deg]):
                    adj[row, j] = other
            self._adj_cache = (torch.from_numpy(adj).to(self.device), n)
            return self._adj_cache

    def traverse(self, seed_rows: Sequence[int], hops: Optional[int] = None,
                 *, query_embedding=None,
                 frontier_cap: int = 64) -> List[List[Dict[str, Any]]]:
        """k-hop entity expansion from seed rows (parity:
        execute_traverse_entity_graph, queries.py:383-407; hop cap 3).
        With `query_embedding`, expansion is beam-pruned by semantic
        relevance (parity: graph_search_workflow expansion_factor)."""
        from ..ops.graph_hop import k_hop_expand

        hops = min(hops or self.cfg.max_hops, self.cfg.max_hops)
        adj, n = self.entity_adjacency()
        if n == 0:
            return [[] for _ in seed_rows]
        seeds = np.full((len(seed_rows), 1), n, dtype=np.int32)
        for i, r in enumerate(seed_rows):
            if 0 <= r < n:
                seeds[i, 0] = r
        scores = None
        if query_embedding is not None:
            scores = self._beam_scores(query_embedding, n)
        visited, hop = k_hop_expand(
            adj, torch.from_numpy(seeds).to(self.device), hops,
            frontier_cap=frontier_cap, scores=scores,
        )
        visited = visited.cpu().numpy()
        hop = hop.cpu().numpy()
        table = self.spaces[Space.ENTITY]
        out = []
        for qi in range(len(seed_rows)):
            items = []
            for row, h in zip(visited[qi], hop[qi]):
                if h < 0 or row >= n:
                    continue
                p = table.get(int(row))
                if p is not None:
                    items.append({"hop": int(h), "row": int(row), **p})
            out.append(items)
        return out

    def _beam_scores(self, query_embedding, n: int) -> torch.Tensor:
        """(n + 1,) f32: the normalized query against the first n entity
        rows (bf16, products in full f32) and 0 for the sentinel."""
        index = self.spaces[Space.ENTITY].index
        q = index.normalize_queries(
            np.asarray(query_embedding, dtype=np.float32)[None, :])[0]
        with full_f32_matmul():
            parts = [index.vecs[s:min(s + _SCORE_ROWS, n)].float() @ q
                     for s in range(0, n, _SCORE_ROWS)]
        return torch.cat(parts + [q.new_zeros(1)])

    def entity_context(self, entity_row: int) -> Dict[str, Any]:
        """An entity joined with its relationships and neighbors (parity:
        execute_get_entity_context, queries.py:640-672)."""
        ent_table = self.spaces[Space.ENTITY]
        rel_table = self.spaces[Space.RELATIONSHIP]
        entity = ent_table.get(entity_row)
        if entity is None:
            return {}
        rels = []
        for rel_row, other in self.entity_edges.get(entity_row, []):
            rp = rel_table.get(rel_row)
            op = ent_table.get(other)
            if rp is not None:
                rels.append({"relationship": rp, "neighbor": op})
        return {"entity": entity, "relationships": rels}
