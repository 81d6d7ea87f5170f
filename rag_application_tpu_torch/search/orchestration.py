"""Search orchestration: LLM-tuned params + parallel hybrid/graph search.

Copy of `rag_application_tpu/search/orchestration.py`, on the port's
`Collection`, `KGStore` and `llm.router`. The device calls of both
branches run in worker threads (`asyncio.to_thread`), as in the
reference.

Parity targets (v1 agent workflows):
  * `SearchParams` — the 8 LLM-chosen funnel knobs with corpus-size
    heuristic fallback (app/services/agents/hybrid_search_workflow.py:
    8-19,68-108). The knobs quantize to powers of two, as the
    reference buckets them.
  * `GraphSearchParams` + LLM entity extraction from the query
    (graph_search_workflow.py:57-119,176-203): per-entity kNN + path
    traversal with relevance thresholds.
  * `SearchOrchestrationWorkflow.execute` — hybrid and graph branches in
    parallel, joined into one combined context prompt
    (search_orchestration_workflow.py:21-41,65-166).
  * `QueryProcessor.process_query` — grounded answer over the combined
    context with the strict RAG system prompt (query_processor.py:115-168).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from ..config import FunnelConfig
from ..kg.store import KGStore, Space
from ..llm.router import LLMRouter
from ..store.collection import Collection, SearchHit
from .params import _bucket, adaptive_funnel

SEARCH_PARAMS_SCHEMA = {
    "type": "object",
    "properties": {
        "matryoshka_64_limit": {"type": "integer"},
        "matryoshka_128_limit": {"type": "integer"},
        "matryoshka_256_limit": {"type": "integer"},
        "dense_limit": {"type": "integer"},
        "quantized_limit": {"type": "integer"},
        "sparse_limit": {"type": "integer"},
        "final_limit": {"type": "integer"},
        "hnsw_ef": {"type": "integer"},
    },
}

GRAPH_PARAMS_SCHEMA = {
    "type": "object",
    "properties": {
        "search_depth": {"type": "integer"},
        "expansion_factor": {"type": "integer"},
        "relevance_threshold": {"type": "number"},
        "max_paths": {"type": "integer"},
    },
}

ENTITY_EXTRACT_SCHEMA = {
    "type": "object",
    "properties": {
        "entities": {"type": "array", "items": {"type": "string"}},
        "relations": {"type": "array", "items": {"type": "string"}},
    },
}


@dataclass
class GraphSearchParams:
    search_depth: int = 2
    expansion_factor: int = 32
    relevance_threshold: float = 0.3
    max_paths: int = 10


async def determine_search_params(
    llm: LLMRouter, query: str, corpus_size: int,
    base: Optional[FunnelConfig] = None,
) -> FunnelConfig:
    """LLM-chosen funnel with heuristic fallback (parity:
    determine_search_params, hybrid_search_workflow.py:68-108). Values
    are bucketed to powers of two."""
    try:
        p = await llm.generate_structured(
            f"Query: {query}\nCollection size: {corpus_size} chunks.\n"
            "Choose hybrid-search candidate limits (each 10-500; final 5-50).",
            SEARCH_PARAMS_SCHEMA,
            system="You tune retrieval funnels.")
        def pick(key, lo, hi, default):
            v = int(p.get(key) or 0)
            return _bucket(min(max(v, lo), hi)) if v else default
        fallback = adaptive_funnel(corpus_size, base)
        return FunnelConfig(
            matryoshka_limits=(
                pick("matryoshka_64_limit", 10, 500, fallback.matryoshka_limits[0]),
                pick("matryoshka_128_limit", 10, 400,
                     fallback.matryoshka_limits[min(1, len(fallback.matryoshka_limits) - 1)]),
                pick("matryoshka_256_limit", 10, 300,
                     fallback.matryoshka_limits[-1]),
            ),
            dense_limit=pick("dense_limit", 10, 200, fallback.dense_limit),
            quantized_limit=pick("quantized_limit", 10, 200,
                                 fallback.quantized_limit),
            sparse_limit=pick("sparse_limit", 10, 100, fallback.sparse_limit),
            final_limit=max(5, min(50, int(p.get("final_limit") or 0)
                                   or fallback.final_limit)),
            rrf_k=fallback.rrf_k,
            final_fusion=fallback.final_fusion,
        )
    except (ValueError, KeyError, TypeError):
        return adaptive_funnel(corpus_size, base)


async def determine_graph_params(llm: LLMRouter, query: str) -> GraphSearchParams:
    """Parity: graph_search_workflow.py:87-119 (depth capped at the
    reference's bounds)."""
    try:
        p = await llm.generate_structured(
            f"Query: {query}\nChoose graph-search parameters "
            "(search_depth 1-3, expansion_factor 8-64, "
            "relevance_threshold 0-1, max_paths 1-20).",
            GRAPH_PARAMS_SCHEMA, system="You tune graph traversals.")
        thr = p.get("relevance_threshold")
        return GraphSearchParams(
            search_depth=min(max(int(p.get("search_depth") or 2), 1), 3),
            expansion_factor=min(max(int(p.get("expansion_factor") or 32), 8), 64),
            # 0.0 is a VALID choice ("no pruning") — `or` would clobber it
            relevance_threshold=(0.3 if thr is None
                                 else min(max(float(thr), 0.0), 1.0)),
            max_paths=min(max(int(p.get("max_paths") or 10), 1), 20),
        )
    except (ValueError, TypeError):
        return GraphSearchParams()


class SearchOrchestrator:
    """Hybrid + graph search in parallel, joined into a grounded answer."""

    def __init__(self, collection: Collection, kg: KGStore, embedder,
                 llm: LLMRouter, *, llm_tuned_params: bool = False):
        self.col = collection
        self.kg = kg
        self.embedder = embedder
        self.llm = llm
        self.llm_tuned_params = llm_tuned_params

    async def _hybrid_branch(self, query: str, q_vec, limit: int):
        funnel = None
        if self.llm_tuned_params:
            funnel = await determine_search_params(
                self.llm, query, self.col.dense.size)
        # device search is synchronous: run in a worker thread so the
        # graph branch's LLM calls (and other requests on the serving
        # loop) actually overlap with it
        return await asyncio.to_thread(
            self.col.hybrid_search, q_vec, query, limit=limit, funnel=funnel)

    async def _graph_branch(self, query: str, q_vec) -> Dict[str, Any]:
        """LLM extracts query entities -> per-entity kNN -> beam-pruned
        traversal (parity: graph_search_workflow.py:121-203)."""
        params = (await determine_graph_params(self.llm, query)
                  if self.llm_tuned_params else GraphSearchParams())
        try:
            extracted = await self.llm.generate_structured(
                f"Extract the entities and relations mentioned in: {query}",
                ENTITY_EXTRACT_SCHEMA, system="You extract query entities.")
        except ValueError:
            extracted = {"entities": [], "relations": []}
        names = (extracted.get("entities") or [])[:5]

        kgq = q_vec[: self.kg.dim]
        # ONE batched encode + per-entity kNN off the loop, rather than
        # an encode and a search per name on the query hot path
        lookups = list(names or [query])
        evs = await asyncio.to_thread(self.embedder.encode, lookups)

        def _entity_knn():
            out: List[Dict[str, Any]] = []
            for ev in evs:
                out.extend(self.kg.search_space(
                    Space.ENTITY, ev[: self.kg.dim], k=3))
            return out

        entity_hits: List[Dict[str, Any]] = await asyncio.to_thread(
            _entity_knn)
        entity_hits = [h for h in entity_hits
                       if h["score"] >= params.relevance_threshold]
        rel_hits = await asyncio.to_thread(
            self.kg.search_space, Space.RELATIONSHIP, kgq, k=5)

        paths: List[List[Dict[str, Any]]] = []
        seed_rows = [h["row"] for h in entity_hits[: params.max_paths]]
        if seed_rows:
            paths = await asyncio.to_thread(
                self.kg.traverse,
                seed_rows, params.search_depth, query_embedding=kgq,
                frontier_cap=params.expansion_factor)
        return {"entities": entity_hits, "relationships": rel_hits,
                "paths": paths, "params": params}

    def prepare_combined_context(self, hits: Sequence[SearchHit],
                                 graph: Dict[str, Any]) -> str:
        """Parity: _prepare_combined_context
        (search_orchestration_workflow.py:65-166)."""
        # 1600 covers the chunker's max chunk (~0.75 x 2048 chars); the
        # old 800-char cap silently cut retrieved chunks in half — 6 of
        # 28 realdocs needles were retrieved into the top-5 hits but
        # absent from the combined context (r4 per-question analysis)
        passages = "\n\n".join(
            f"[{h.payload.get('document_id')}#{h.payload.get('chunk_index')}]"
            f" {str(h.payload.get('text', ''))[:1600]}" for h in hits)
        ents = "\n".join(
            f"- {e.get('text')} ({e.get('entity_type')}): "
            f"{str(e.get('entity_profile', ''))[:150]}"
            for e in graph.get("entities", []))
        rels = "\n".join(
            f"- {r.get('source')} -[{r.get('relation_type')}]-> {r.get('target')}"
            for r in graph.get("relationships", []))
        path_lines = []
        for path in graph.get("paths", []):
            chain = " -> ".join(f"{p.get('text')}(h{p['hop']})" for p in path)
            if chain:
                path_lines.append(f"- {chain}")
        return (f"PASSAGES:\n{passages}\n\nENTITIES:\n{ents}\n\n"
                f"RELATIONSHIPS:\n{rels}\n\n"
                f"KNOWLEDGE PATHS:\n" + "\n".join(path_lines))

    async def execute(self, query: str, *, limit: int = 5) -> Dict[str, Any]:
        q_vec = (await asyncio.to_thread(self.embedder.encode, [query]))[0]
        hits, graph = await asyncio.gather(
            self._hybrid_branch(query, q_vec, limit),
            self._graph_branch(query, q_vec),
        )
        return {"hits": hits, "graph": graph,
                "context": self.prepare_combined_context(hits, graph)}

    async def ask(self, question: str, *, limit: int = 5) -> Dict[str, Any]:
        """Parity: QueryProcessor.process_query (query_processor.py:115-168)."""
        result = await self.execute(question, limit=limit)
        answer = await self.llm.generate_text(
            f"Context:\n{result['context']}\n\nQuestion: {question}",
            system=("You are a retrieval-grounded assistant. Answer ONLY "
                    "from the provided context; say you do not know "
                    "otherwise. Cite document ids."))
        return {
            "answer": answer,
            "sources": [
                {"document_id": h.payload.get("document_id"),
                 "chunk_index": h.payload.get("chunk_index"),
                 "score": h.score} for h in result["hits"]],
            "graph": {
                "entities": len(result["graph"]["entities"]),
                "relationships": len(result["graph"]["relationships"]),
                "paths": len(result["graph"]["paths"]),
            },
        }
