"""BM25 sparse retrieval as dense tensor ops.

Port of `rag_application_tpu/ops/bm25.py`. Retrieval runs in two dense
stages:

  1. *Impact-ordered candidate generation.* A query gathers its terms'
     fixed-width posting rows (term-major, sorted by impact, truncated at
     P), flattens them to (Q, T*P) and keeps the top `pool` by
     single-term impact.
  2. *Exact rescore.* Candidates are deduplicated (sort + run-boundary
     mask) and rescored exactly from the doc-major view: the match sums
     precisely the impacts BM25 assigns. Final top-k over exact scores.

`bm25_match_rows` and `bm25_match_scores` are the wrappers of one
kernel, `csrc/bm25_match.cu` (the port of the Pallas `_match_kernel`,
with the sum over L fused in). `bm25_match_rows` takes the doc-major
table and the candidate ids, and on CUDA tensors the kernel reads each
candidate's row itself (stage 2 of `bm25_topk`); `bm25_match_scores`
keeps the reference's contract, rows already gathered. On CPU tensors
each runs its plain version (`bm25_match_rows_plain` is the gather, then
`bm25_match_scores_plain`). Kernel and plain version add the L slots in
order, so they agree bit for bit. Packed postings and doc-major weights
are bitcast with `.view()`, never cast.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import count_launch, launch, ptr
from .topk import NEG_INF, stable_topk


def bm25_match_scores_plain(dt: torch.Tensor, dw: torch.Tensor,
                            q_terms: torch.Tensor,
                            q_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the match kernel:
    (Q, pool, L) doc terms/weights vs (Q, T) query terms -> (Q, pool)
    = sum over l (in order l = 0..L-1) of dw where dt is a valid query
    term."""
    hit_any = ((dt[..., None] == q_terms[:, None, None, :])
               & q_valid[:, None, None, :]).any(dim=-1)  # (Q, pool, L)
    w = torch.where(hit_any, dw.float(), 0.0)
    acc = torch.zeros(dt.shape[:2], dtype=torch.float32, device=dt.device)
    for s in range(dt.shape[-1]):
        acc = acc + w[..., s]
    return acc


def bm25_match_rows_plain(doc_packed: torch.Tensor, cand: torch.Tensor,
                          q_terms: torch.Tensor,
                          q_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `bm25_match_rows`: the gather of the
    candidates' packed rows, then `bm25_match_scores_plain`."""
    l = doc_packed.shape[1] // 2
    packed = doc_packed[cand.long()]  # (Q, pool, 2L) int32
    return bm25_match_scores_plain(packed[..., :l],
                                   packed[..., l:].view(torch.float32),
                                   q_terms, q_valid)


def _check_query(name: str, q: int, q_terms: torch.Tensor,
                 q_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if q_terms.dtype != torch.int32 or q_valid.dtype != torch.bool:
        raise TypeError(f"{name}: q_terms int32, q_valid bool")
    if q_terms.dim() != 2 or q_terms.shape[0] != q \
            or q_valid.shape != q_terms.shape:
        raise ValueError(f"{name}: q_terms/q_valid must be (Q, T) with Q "
                         f"= {q}")
    return q_terms.contiguous(), q_valid.contiguous()


def bm25_match_rows(doc_packed: torch.Tensor, cand: torch.Tensor,
                    q_terms: torch.Tensor,
                    q_valid: torch.Tensor) -> torch.Tensor:
    """(N+1, 2L) doc-major table and (Q, pool) candidate ids vs (Q, T)
    query terms -> (Q, pool): the match of each candidate's row.

    Kernel wrapper: for CUDA tensors it launches `csrc/bm25_match.cu`,
    which reads each candidate's packed row by id (no gathered copy);
    for CPU tensors it runs `bm25_match_rows_plain`. ``doc_packed`` holds
    int32 terms in columns :L and bitcast f32 weights in L:, row N the
    sentinel; ``cand`` int32 ids in [0, N]."""
    if doc_packed.device.type == "cpu":
        return bm25_match_rows_plain(doc_packed, cand, q_terms, q_valid)
    if doc_packed.device.type != "cuda":
        raise ValueError(f"bm25_match_rows: unsupported device "
                         f"{doc_packed.device}")
    if doc_packed.dtype != torch.int32 or cand.dtype != torch.int32:
        raise TypeError("bm25_match_rows: doc_packed and cand int32 needed")
    if doc_packed.dim() != 2 or doc_packed.shape[1] % 2 \
            or doc_packed.stride(1) != 1 or cand.dim() != 2:
        raise ValueError("bm25_match_rows: doc_packed (N+1, 2L) with unit "
                         "column stride and cand (Q, pool) needed")
    q, pool = cand.shape
    l = doc_packed.shape[1] // 2
    q_terms, q_valid = _check_query("bm25_match_rows", q, q_terms, q_valid)
    devs = {x.device for x in (doc_packed, cand, q_terms, q_valid)}
    if len(devs) != 1:
        raise ValueError("bm25_match_rows: tensors on different devices")
    cand = cand.contiguous()
    out = torch.empty((q, pool), dtype=torch.float32, device=cand.device)
    if q == 0 or pool == 0:
        return out
    launch("bm25_match_launch", cand.device, ptr(doc_packed),
           doc_packed.stride(0), ptr(doc_packed[:, l:]), doc_packed.stride(0),
           ptr(cand), doc_packed.shape[0], q, pool, l, ptr(q_terms),
           ptr(q_valid), q_terms.shape[1], ptr(out))
    count_launch(bm25_match_rows)
    return out


bm25_match_rows.launches = 0


def bm25_match_scores(dt: torch.Tensor, dw: torch.Tensor,
                      q_terms: torch.Tensor,
                      q_valid: torch.Tensor) -> torch.Tensor:
    """(Q, pool, L) doc terms/weights vs (Q, T) query terms -> (Q, pool);
    the reference's contract, rows already gathered.

    Kernel wrapper: launches `csrc/bm25_match.cu` on the rows as they lie
    for CUDA tensors and runs the plain version for CPU tensors.
    ``dt``/``dw`` may be column slices of the gathered doc-major rows
    (unit last stride, uniform row stride)."""
    if dt.device.type == "cpu":
        return bm25_match_scores_plain(dt, dw, q_terms, q_valid)
    if dt.device.type != "cuda":
        raise ValueError(f"bm25_match_scores: unsupported device {dt.device}")
    q, pool, l = dt.shape
    if dt.dtype != torch.int32 or dw.dtype != torch.float32:
        raise TypeError("bm25_match_scores: dt int32 and dw float32 needed")
    if dw.shape != dt.shape:
        raise ValueError("bm25_match_scores: shape mismatch")
    q_terms, q_valid = _check_query("bm25_match_scores", q, q_terms, q_valid)
    for name, x in (("dt", dt), ("dw", dw)):
        if x.stride(2) != 1 or x.stride(0) != pool * x.stride(1):
            raise ValueError(f"bm25_match_scores: {name} needs unit last "
                             "stride and a uniform row stride")
    devs = {x.device for x in (dt, dw, q_terms, q_valid)}
    if len(devs) != 1:
        raise ValueError("bm25_match_scores: tensors on different devices")
    out = torch.empty((q, pool), dtype=torch.float32, device=dt.device)
    if q == 0 or pool == 0:
        return out
    launch("bm25_match_launch", dt.device, ptr(dt), dt.stride(1), ptr(dw),
           dw.stride(1), None, 0, q, pool, l, ptr(q_terms), ptr(q_valid),
           q_terms.shape[1], ptr(out))
    count_launch(bm25_match_scores)
    return out


bm25_match_scores.launches = 0


def bm25_impact_weights(tf, doc_len, idf, *, k1: float = 1.2,
                        b: float = 0.75, avgdl: float = 1.0) -> torch.Tensor:
    """Per-(term, doc) BM25 impact weight, idf * tf*(k1+1) /
    (tf + k1*(1-b+b*dl/avgdl)), so query scoring is a lookup-sum."""
    tf = tf.float()
    denom = tf + k1 * (1.0 - b + b * doc_len.float() / avgdl)
    return idf.float() * tf * (k1 + 1.0) / denom


def _dedup_sorted(cand: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Sort candidate ids ascending and replace duplicate runs with pad_id."""
    s, _ = torch.sort(cand, dim=-1)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    return torch.where(dup, pad_id, s)


def pack_doc_major(doc_terms: torch.Tensor,
                   doc_weights: torch.Tensor) -> torch.Tensor:
    """Interleave terms + weights into one (N+1, 2L) int32 array (weights
    bitcast), so the stage-2 gather fetches one row per candidate."""
    w_bits = doc_weights.float().contiguous().view(torch.int32)
    return torch.cat([doc_terms.to(torch.int32), w_bits], dim=-1)


def bm25_candidates(post_docs: torch.Tensor,
                    post_weights: Optional[torch.Tensor], n_docs: int,
                    q_rows: torch.Tensor, q_valid: torch.Tensor,
                    pool: int) -> torch.Tensor:
    """Stage 1: the top ``pool`` postings of the query's terms by
    single-term impact, deduplicated -> (Q, pool) sorted doc ids, with
    duplicates and padding = ``n_docs``."""
    q, t = q_rows.shape
    p = post_docs.shape[1]
    pool_eff = min(pool, t * p)
    rows = q_rows.long()
    if post_weights is None:
        # packed postings rank by the raw ints bitcast to f32 (monotone for
        # positive int32); stage 2 rescores exactly
        pk = post_docs[rows]  # (Q, T, P) int32
        pk = torch.where(q_valid[..., None], pk, n_docs)
        flat = pk.reshape(q, t * p)
        _, pos = stable_topk(flat.view(torch.float32), pool_eff)
        cand = torch.gather(flat, -1, pos) & ((1 << 21) - 1)
        cand = torch.clamp(cand, max=n_docs)
    else:
        cand_docs = post_docs[rows]  # (Q, T, P)
        cand_w = post_weights[rows].float()
        cand_w = torch.where(q_valid[..., None], cand_w, 0.0)
        flat_docs = cand_docs.reshape(q, t * p)
        flat_w = cand_w.reshape(q, t * p)
        flat_w = torch.where(flat_docs < n_docs, flat_w, 0.0)
        _, pos = stable_topk(flat_w, pool_eff)
        cand = torch.gather(flat_docs, -1, pos)  # (Q, pool)
    return _dedup_sorted(cand, n_docs)


def bm25_topk(
    post_docs: torch.Tensor,
    post_weights: Optional[torch.Tensor],
    doc_packed: torch.Tensor,
    q_rows: torch.Tensor,
    q_terms: torch.Tensor,
    q_valid: torch.Tensor,
    k: int,
    *,
    pool: int = 512,
    filter_mask: Optional[torch.Tensor] = None,
    approx: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched BM25 top-k; the reference's argument contract.

    post_docs (T_active, P) int32 doc ids, or with ``post_weights=None``
    the packed layout ``(impact_q10 << 21) | doc_id`` (padding = N);
    post_weights (T_active, P) f16/f32 or None; doc_packed (N+1, 2L)
    int32 terms + bitcast f32 weights (row N = sentinel); q_rows/q_terms
    (Q, T) int32, q_valid (Q, T) bool; filter_mask optional (N,) bool.
    ``approx`` selects the same exact top-k as the reference on CPU.

    Returns (scores (Q, k) f32, ids (Q, k) int32); empty slots have score
    -inf and id N.
    """
    del approx
    n_docs = doc_packed.shape[0] - 1
    cand = bm25_candidates(post_docs, post_weights, n_docs, q_rows, q_valid,
                           pool)

    # stage 2: the match reads each candidate's packed doc-major row
    scores = bm25_match_rows(doc_packed, cand, q_terms, q_valid)  # (Q, pool)

    valid = cand < n_docs
    if filter_mask is not None:
        fm = torch.cat([filter_mask,
                        torch.zeros(1, dtype=torch.bool,
                                    device=filter_mask.device)])
        valid = valid & fm[cand.long()]
    scores = torch.where(valid & (scores > 0.0), scores, NEG_INF)

    top_scores, top_pos = stable_topk(scores, min(k, cand.shape[-1]))
    top_ids = torch.gather(cand, -1, top_pos)
    top_ids = torch.where(top_scores > NEG_INF, top_ids, n_docs)
    return top_scores, top_ids
