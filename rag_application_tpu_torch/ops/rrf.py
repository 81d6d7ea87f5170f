"""Reciprocal-rank fusion of candidate lists.

Port of `rag_application_tpu/ops/rrf.py`. Candidate lists are small, so
the fusion is a dense rank-matching problem: the union is a
concatenation, each element's rank in each list comes from an equality
match, and duplicates are suppressed by a first-occurrence mask.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .topk import NEG_INF, stable_topk

INVALID_ID = 2147483647  # int32 max, as the reference's jnp.int32 sentinel


def first_occurrence_mask(ids: torch.Tensor) -> torch.Tensor:
    """(Q, S) -> (Q, S) bool mask keeping the first occurrence of each id.
    Quadratic in S (a few hundred at most)."""
    s = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]  # (Q, S, S)
    pos = torch.arange(s, device=ids.device)
    earlier = pos[None, :, None] > pos[None, None, :]  # j earlier than i
    return ~torch.any(eq & earlier, dim=-1)


def rrf_fuse(
    lists: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    k: int,
    *,
    rrf_k: int = 60,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse ranked (ids (Q, K_j) int32, valid (Q, K_j) bool) lists with
    reciprocal rank fusion (rank r contributes 1 / (rrf_k + r + 1)).
    Returns (scores (Q, k) f32, ids (Q, k) int32); slots beyond the
    union's valid size hold -inf and INVALID_ID."""
    masked_lists = [torch.where(valid, ids.to(torch.int32), INVALID_ID)
                    for ids, valid in lists]
    union = torch.cat(masked_lists, dim=-1)  # (Q, S)

    score = torch.zeros(union.shape, dtype=torch.float32, device=union.device)
    for masked in masked_lists:
        match = union[..., :, None] == masked[..., None, :]  # (Q, S, K_j)
        ranks = torch.arange(masked.shape[-1], dtype=torch.float32,
                             device=union.device)
        contrib = 1.0 / (rrf_k + ranks + 1.0)
        score = score + torch.where(match, contrib[None, None, :],
                                    0.0).sum(dim=-1)

    keep = first_occurrence_mask(union) & (union != INVALID_ID)
    score = torch.where(keep, score, NEG_INF)

    k_eff = min(k, union.shape[-1])
    top_scores, top_pos = stable_topk(score, k_eff)
    top_ids = torch.gather(union, -1, top_pos)
    top_ids = torch.where(top_scores > NEG_INF, top_ids, INVALID_ID)
    if k_eff < k:
        pad = k - k_eff
        top_scores = torch.nn.functional.pad(top_scores, (0, pad),
                                             value=NEG_INF)
        top_ids = torch.nn.functional.pad(top_ids, (0, pad),
                                          value=INVALID_ID)
    return top_scores, top_ids
