"""The hybrid query pipeline, stage by stage.

Port of `rag_application_tpu/search/hybrid.py`. Parity target:
`QdrantHandler.hybrid_search` (app/core/vector_store/qdrant/
qdrant_handler.py:269-412):

  reference (server-side Qdrant)              here (on the device)
  ------------------------------              --------------------
  matryoshka prefetch cascade                 prefix-view corpus scan ->
    64(100) -> 128(80) -> 256(60) (:305-330)    prefix rescores (gathers)
  int8 prefetch -> dense refine (:333-344)    int8 corpus scan -> exact
                                                dense rescore of candidates
  sparse BM25 prefetch (:347-354)             bm25_topk (the BM25 match
                                                kernel, csrc/bm25_match.cu)
  RRF(quantized, sparse) (:357-360)           subsumed (see below)
  final dense rescore, exact=True (:363-372)  exact gather-rescore over the
                                                candidate union

The dense legs scan through `DenseIndex.search_*` (`ops.topk.blocked_topk`,
plain torch), as the reference's staged path scans through its XLA
`blocked_topk`; the production path with the fused scan kernel is
`search/fused.py`, which `Collection` routes through. Every top-k is
`ops.topk.stable_topk` (`lax.top_k`'s tie order). Only the BM25 query
analysis (string -> term ids) runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FunnelConfig
from ..index.dense import DenseIndex
from ..index.sparse import SparseIndex
from ..ops.bm25 import bm25_topk
from ..ops.rrf import INVALID_ID, first_occurrence_mask
from ..ops.topk import NEG_INF, stable_topk


@dataclass
class HybridResult:
    scores: np.ndarray  # (Q, k) f32, -inf padding
    rows: np.ndarray  # (Q, k) int32, INVALID_ID padding
    valid: np.ndarray  # (Q, k) bool


def _refine(index: DenseIndex, queries, vals, ids, k: int,
            level: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rescore candidate ids at a finer view and keep the top-k."""
    valid = torch.isfinite(vals)
    scores = index.rescore(queries, ids, candidate_valid=valid, level=level)
    top_scores, pos = stable_topk(scores, min(k, ids.shape[-1]))
    return top_scores, torch.gather(ids, -1, pos)


def hybrid_search(
    dense: DenseIndex,
    sparse: Optional[SparseIndex],
    query_embeddings,
    query_texts: Optional[Sequence[str]],
    k: Optional[int] = None,
    *,
    funnel: Optional[FunnelConfig] = None,
    filter_mask=None,
    use_matryoshka: bool = True,
) -> HybridResult:
    """Run the staged hybrid funnel for a query batch.

    Args:
      dense: the dense index shard.
      sparse: BM25 index (None disables the sparse branch).
      query_embeddings: (Q, d) raw query embeddings.
      query_texts: raw query strings for the BM25 branch.
      k: final results per query (default funnel.final_limit).
      funnel: candidate funnel; defaults to the reference's defaults.
      filter_mask: (N-capacity,) bool payload filter, aligned to rows.
      use_matryoshka: False disables the prefix cascade.

    This staged path always ranks the final union by exact dense score;
    `FunnelConfig.final_fusion` is honoured by `search/fused.py`.
    """
    f = funnel or FunnelConfig()
    k = k or f.final_limit
    if filter_mask is not None:
        filter_mask = torch.as_tensor(filter_mask, device=dense.device)
    q = dense.normalize_queries(query_embeddings)

    branch_ids = []  # candidate lists entering the final exact rescore

    # --- matryoshka cascade: coarse scan, then prefix-view refinements ---
    if use_matryoshka and dense.cfg.matryoshka_dims:
        m = f.matryoshka_limits
        vals, ids = dense.search_matryoshka(q, m[0], 0,
                                            filter_mask=filter_mask)
        for level in range(1, len(dense.cfg.matryoshka_dims)):
            if level >= len(m):
                break
            vals, ids = _refine(dense, q, vals, ids, m[level], level)
        vals, ids = _refine(dense, q, vals, ids, f.dense_limit, None)
        branch_ids.append((vals, ids))

    # --- int8 branch: quantized scan -> rank-select refine ---
    # the scan scores are full-dim int8 dots, so the refine set is chosen
    # from them directly; the final union rescore gives exact scores
    i8_vals, i8_ids = dense.search_int8(q, f.quantized_limit,
                                        filter_mask=filter_mask)
    i8_vals, pos = stable_topk(i8_vals, min(f.dense_limit,
                                            i8_ids.shape[-1]))
    i8_ids = torch.gather(i8_ids, -1, pos)
    branch_ids.append((i8_vals, i8_ids))

    # --- sparse BM25 branch ---
    if sparse is not None and query_texts is not None and len(sparse) > 0:
        dv = sparse.device_arrays()
        q_rows, q_terms, q_valid = sparse.encode_queries(list(query_texts))
        fm = filter_mask[: len(sparse)] if filter_mask is not None else None
        sp_scores, sp_ids = bm25_topk(
            dv["post_docs"], dv["post_weights"], dv["doc_packed"],
            q_rows, q_terms, q_valid, f.sparse_limit,
            pool=sparse.cfg.candidate_pool, filter_mask=fm,
        )
        sp_valid = torch.isfinite(sp_scores)
        branch_ids.append((torch.where(sp_valid, 0.0, NEG_INF), sp_ids))

    # RRF of quantized-dense + sparse (parity :357-360) is skipped as pure
    # compute: the fused list is a subset of the union already entering
    # the exact rescore, so it cannot change the output.

    # --- final exact dense rescore over the candidate union (:363-372) ---
    all_ids = torch.cat([ids.to(torch.int32) for _, ids in branch_ids],
                        dim=-1)
    all_valid = torch.cat([torch.isfinite(vals) for vals, _ in branch_ids],
                          dim=-1)
    all_ids = torch.where(all_valid, all_ids, INVALID_ID)
    keep = first_occurrence_mask(all_ids) & (all_ids != INVALID_ID)
    final_scores = dense.rescore(q, torch.where(keep, all_ids, 0),
                                 candidate_valid=keep)
    top_scores, pos = stable_topk(final_scores, min(k, all_ids.shape[-1]))
    top_ids = torch.gather(all_ids, -1, pos)
    valid = torch.isfinite(top_scores)
    top_ids = torch.where(valid, top_ids, INVALID_ID)

    return HybridResult(
        scores=top_scores.cpu().numpy(),
        rows=top_ids.cpu().numpy(),
        valid=valid.cpu().numpy(),
    )


class HybridSearcher:
    """Convenience facade pairing a DenseIndex and SparseIndex.

    Mirrors the per-collection surface of `QdrantHandler`
    (create_collection == construction; store_document_vectors == add;
    hybrid_search == search; get_collection_chunk_count == len).
    """

    def __init__(self, dense: DenseIndex, sparse: Optional[SparseIndex] = None,
                 funnel: Optional[FunnelConfig] = None):
        self.dense = dense
        self.sparse = sparse
        self.funnel = funnel

    def __len__(self) -> int:
        return self.dense.size

    def add(self, embeddings, texts: Optional[Sequence[str]] = None
            ) -> np.ndarray:
        rows = self.dense.insert(embeddings)
        if self.sparse is not None and texts is not None:
            sparse_rows = self.sparse.add_batch(list(texts))
            if list(sparse_rows) != list(rows):
                raise RuntimeError("dense/sparse row drift")
        return rows

    def delete(self, rows) -> None:
        self.dense.delete(rows)
        if self.sparse is not None:
            for r in np.asarray(rows).tolist():
                self.sparse.delete(r)

    def search(self, query_embeddings, query_texts=None, k: int = 10,
               **kw) -> HybridResult:
        return hybrid_search(self.dense, self.sparse, query_embeddings,
                             query_texts, k, funnel=self.funnel, **kw)
