"""Collection facade: the `QdrantHandler` parity surface.

Port of `rag_application_tpu/store/collection.py`. A `Collection` binds a
DenseIndex + SparseIndex + PayloadStore over one row space on one device;
the `VectorStore` registry maps user ids to collections. Writes go through
`DenseIndex.insert`, whose prep pass is the `csrc/prep_vectors.cu` kernel
on the card. Reads go through the fused funnel, by vector
(`hybrid_search_batch`) or by text over the tokens wire
(`bind_query_encoder` + `hybrid_search_text_batch`).

`index/checkpoint.py` saves and restores a collection in the reference's
file format (`save_collection` / `load_collection`). `build_ann` builds
the IVF engine (`index/ivf.py`) over the collection's rows on its device,
and `ann_search` queries it with the payload filter as a device mask.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, FunnelConfig
from ..index.dense import DenseIndex
from ..index.payload import PayloadStore
from ..index.sparse import SparseIndex
from ..search.fused import FusedSearcher
from ..search.params import adaptive_funnel
from ..utils import DeviceLike, resolve_device


@dataclass
class SearchHit:
    score: float
    row: int
    payload: Dict[str, Any]


def mutator(fn):
    """Serialize writers and the checkpoint capture
    (`index/checkpoint.py::save_collection`) on the collection's lock, so
    dense, sparse and payload rows never drift apart mid-insert."""
    @functools.wraps(fn)
    def inner(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)
    return inner


class Collection:
    def __init__(self, name: str, config: Optional[Config] = None, *,
                 device: DeviceLike = None):
        self.name = name
        self.cfg = config or Config()
        self.device = resolve_device(device)
        self.lock = threading.RLock()
        self.dense = DenseIndex(self.cfg.index, device=self.device)
        self.sparse = SparseIndex(self.cfg.sparse, device=self.device)
        self.payloads = PayloadStore()
        self._fused = FusedSearcher(self.dense, self.sparse, self.cfg.funnel)
        self.reranker = None  # optional LateInteractionReranker

    def set_reranker(self, reranker) -> None:
        """Attach a late-interaction reranker (parity: rerank_with_colbert,
        qdrant_handler.py:380,388-412 — applied when funnel.rerank)."""
        self.reranker = reranker

    # ------------------------------------------------------------------ ANN

    def build_ann(self, *, engine: str = "ivf", **kw) -> None:
        """Build the sublinear ANN engine over the current rows (the
        HNSW-equivalent; `ef` at query time parities `hnsw_ef`).
        engine="ivf" is the only engine: the coarse-quantizer partition
        scan of index/ivf.py."""
        if engine != "ivf":
            raise ValueError(f"unknown ANN engine {engine!r} "
                             "(the graph engine was removed; use 'ivf')")
        from ..index.ivf import IVFIndex

        self.ann = IVFIndex.build(self.dense, **kw)

    def ann_search(self, query_embedding, limit: int = 10, *, ef: int = 128,
                   **filters) -> List[SearchHit]:
        """ANN query with payload join + filters (`ef` maps to IVF
        probes — the same more-work-more-recall contract as hnsw_ef,
        qdrant_handler.py:369)."""
        if getattr(self, "ann", None) is None:
            raise RuntimeError("call build_ann() first")
        from ..index.ivf import IVFIndex, IVFSearchParams

        mask = self.payloads.filter_mask(self.dense.capacity, **filters)
        assert isinstance(self.ann, IVFIndex)
        vals, ids = self.ann.search(
            np.asarray(query_embedding)[None, :], limit,
            params=IVFSearchParams(probes=ef),
            filter_mask=(torch.from_numpy(mask).to(self.device)
                         if mask is not None else None))
        hits = []
        for score, row in zip(vals[0].cpu().numpy(), ids[0].cpu().numpy()):
            if not np.isfinite(score):
                continue
            payload = self.payloads.get(int(row))
            if payload is not None:
                hits.append(SearchHit(float(score), int(row), payload))
        return hits

    # ------------------------------------------------------------- writes

    @mutator
    def store_document_vectors(
        self,
        document_id: str,
        chunks: Sequence[Dict[str, Any]],
        embeddings,
        *,
        extra_payload: Optional[Dict[str, Any]] = None,
    ) -> List[int]:
        """Store one document's chunks (parity: store_document_vectors,
        qdrant_handler.py:120-198)."""
        payloads = []
        texts = []
        for i, chunk in enumerate(chunks):
            p = dict(chunk)
            p.setdefault("document_id", document_id)
            p.setdefault("chunk_index", i)
            p.setdefault("kind", "document")
            if extra_payload:
                p.update(extra_payload)
            payloads.append(p)
            texts.append(p.get("text", ""))
        rows = self.dense.insert(embeddings)
        sparse_rows = self.sparse.add_batch(texts)
        payload_rows = self.payloads.add(payloads)
        assert list(rows) == sparse_rows == payload_rows, "row drift"
        return list(rows)

    def store_chat_vectors(self, thread_id: str,
                           messages: Sequence[Dict[str, Any]],
                           embeddings) -> List[int]:
        """Chat-memory vectors (parity: store_chat_vectors,
        qdrant_handler.py:200-267)."""
        chunks = [dict(m, kind="chat", thread_id=thread_id) for m in messages]
        return self.store_document_vectors(f"chat:{thread_id}", chunks,
                                           embeddings)

    @mutator
    def delete_document(self, document_id: str) -> int:
        """Tombstone every chunk of a document (parity: reset_document /
        delete cascade, IndexerAPI neo4j_handler.py:99-152)."""
        rows = self.payloads.rows_where(document_id=document_id)
        if rows:
            self.dense.delete(np.asarray(rows))
            for r in rows:
                self.sparse.delete(r)
            self.payloads.delete(rows)
        return len(rows)

    # -------------------------------------------------------------- reads

    def chunk_count(self, **filters) -> int:
        """Parity: get_collection_chunk_count (qdrant_handler.py:441-480 —
        optional equality filters count only matching chunks)."""
        if filters:
            return len(self.payloads.rows_where(**filters))
        return int(self.dense.live.sum().item())

    def _funnel(self, funnel: Optional[FunnelConfig],
                adaptive: bool) -> FunnelConfig:
        if funnel is not None:
            return funnel
        return (adaptive_funnel(self.dense.size, self.cfg.funnel)
                if adaptive else self.cfg.funnel)

    def _filter(self, filters) -> Optional[torch.Tensor]:
        mask = self.payloads.filter_mask(self.dense.capacity, **filters)
        return (torch.from_numpy(mask).to(self.device)
                if mask is not None else None)

    def hybrid_search(
        self,
        query_embedding,
        query_text: Optional[str] = None,
        limit: int = 10,
        *,
        funnel: Optional[FunnelConfig] = None,
        adaptive: bool = True,
        use_matryoshka: bool = True,
        **filters,
    ) -> List[SearchHit]:
        """Single-query hybrid search returning payload-joined hits."""
        hits = self.hybrid_search_batch(
            np.asarray(query_embedding)[None, :],
            [query_text] if query_text is not None else None,
            limit, funnel=funnel, adaptive=adaptive,
            use_matryoshka=use_matryoshka, **filters,
        )
        return hits[0]

    def hybrid_search_batch(
        self,
        query_embeddings,
        query_texts: Optional[Sequence[str]] = None,
        limit: int = 10,
        *,
        funnel: Optional[FunnelConfig] = None,
        adaptive: bool = True,
        use_matryoshka: bool = True,
        **filters,
    ) -> List[List[SearchHit]]:
        funnel = self._funnel(funnel, adaptive)
        if not isinstance(query_embeddings, torch.Tensor):
            query_embeddings = np.asarray(query_embeddings)
        scores_d, rows_d = self._fused.search(
            query_embeddings, query_texts, limit, funnel=funnel,
            filter_mask=self._filter(filters),
            use_matryoshka=use_matryoshka,
        )
        return self._join_hits(scores_d, rows_d, funnel, query_texts)

    def _join_hits(self, scores_d, rows_d, funnel, query_texts
                   ) -> List[List[SearchHit]]:
        scores = scores_d.cpu().numpy()
        rows = rows_d.cpu().numpy()
        valid = np.isfinite(scores)
        out: List[List[SearchHit]] = []
        for qi in range(rows.shape[0]):
            hits = []
            for score, row, ok in zip(scores[qi], rows[qi], valid[qi]):
                if not ok:
                    continue
                payload = self.payloads.get(int(row))
                if payload is None:
                    continue
                hits.append(SearchHit(float(score), int(row), payload))
            out.append(hits)

        if funnel.rerank and self.reranker is not None and query_texts:
            cand_texts = [[str(h.payload.get("text", "")) for h in hits]
                          for hits in out]
            orders = self.reranker.rerank(list(query_texts), cand_texts)
            out = [[hits[j] for j in order]
                   for hits, order in zip(out, orders)]
        return out

    # ------------------------------------------------------- tokens wire

    def bind_query_encoder(self, embedder) -> None:
        """Enable `hybrid_search_text_batch`: queries tokenize on the host
        and the device runs the encoder forward and the funnel back to
        back (FusedSearcher.search_tokens)."""
        self._fused.bind_encoder(embedder.state.model,
                                 embedder.state.params)
        self._query_tokenizer = embedder.tokenizer
        self._query_max_len = embedder.max_len

    def hybrid_search_text_batch(
        self,
        query_texts: Sequence[str],
        limit: int = 10,
        *,
        funnel: Optional[FunnelConfig] = None,
        adaptive: bool = True,
        use_matryoshka: bool = True,
        **filters,
    ) -> List[List[SearchHit]]:
        """Text-in hybrid search over the tokens wire (requires
        `bind_query_encoder`); the rows of encode-then-
        `hybrid_search_batch`."""
        if getattr(self, "_query_tokenizer", None) is None:
            raise ValueError("call bind_query_encoder(embedder) first")
        funnel = self._funnel(funnel, adaptive)
        ids, amask = self._query_tokenizer.encode_batch(
            list(query_texts), self._query_max_len)
        scores_d, rows_d = self._fused.search_tokens(
            ids, list(query_texts), limit, attn_mask=amask,
            filter_mask=self._filter(filters),
            use_matryoshka=use_matryoshka, funnel=funnel,
        )
        return self._join_hits(scores_d, rows_d, funnel,
                               list(query_texts))


class VectorStore:
    """Registry of per-user collections (parity: QdrantHandler's
    `user_{id}` collection naming, qdrant_handler.py:30-32)."""

    def __init__(self, config: Optional[Config] = None, *,
                 device: DeviceLike = None):
        self.cfg = config or Config()
        self.device = resolve_device(device)
        self._collections: Dict[str, Collection] = {}

    def get_or_create(self, user_id: str) -> Collection:
        name = f"user_{user_id}"
        if name not in self._collections:
            self._collections[name] = Collection(name, self.cfg,
                                                 device=self.device)
        return self._collections[name]

    def drop(self, user_id: str) -> bool:
        return self._collections.pop(f"user_{user_id}", None) is not None

    def names(self) -> List[str]:
        return sorted(self._collections)

    def collections(self) -> List[Collection]:
        return list(self._collections.values())
