"""Late-interaction reranking (ColBERT-style maxsim).

Port of `rag_application_tpu/search/rerank.py`. Candidates are re-encoded
with the framework encoder in token mode (``return_tokens=True``) and
scored by true late interaction: for each (query, doc) pair, the sum over
query tokens of the max similarity over doc tokens. The reference's
`maxsim_scores` is one XLA einsum plus masked reductions, so its port is
plain torch (one batched product on the device).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import full_f32_matmul


def maxsim_scores(
    q_tokens: torch.Tensor,  # (Q, Tq, D)
    q_mask: torch.Tensor,    # (Q, Tq) bool
    d_tokens: torch.Tensor,  # (Q, M, Td, D)
    d_mask: torch.Tensor,    # (Q, M, Td) bool
) -> torch.Tensor:
    """Late-interaction scores (Q, M): sum_t max_s <q_t, d_s>."""
    qf = q_tokens.float()
    df = d_tokens.float()
    qf = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=-1, keepdim=True),
                          min=1e-9)
    df = df / torch.clamp(torch.linalg.vector_norm(df, dim=-1, keepdim=True),
                          min=1e-9)
    with full_f32_matmul():
        sim = torch.einsum("qtd,qmsd->qmts", qf, df)  # (Q, M, Tq, Td)
    sim = torch.where(d_mask[:, :, None, :], sim, float("-inf"))
    best = torch.amax(sim, dim=-1)  # (Q, M, Tq)
    best = torch.where(q_mask[:, None, :], best, 0.0)
    best = torch.where(torch.isfinite(best), best, 0.0)  # all-padding docs
    return best.sum(dim=-1)


class LateInteractionReranker:
    def __init__(self, embedder, *, budget_tokens: int = 8000):
        """`embedder` must expose `.state` (model/params), `.tokenizer`,
        `.max_len` and `.device` — the standard Embedder."""
        self.embedder = embedder
        self.budget_tokens = budget_tokens

    def _encode_tokens(self, texts: Sequence[str], max_len: int):
        ids, mask = self.embedder.tokenizer.encode_batch(list(texts), max_len)
        dev = self.embedder.device
        mask_t = torch.from_numpy(mask).to(dev)
        _, tokens = self.embedder.state.model.apply(
            self.embedder.state.params, torch.from_numpy(ids).to(dev),
            mask_t, return_tokens=True)
        return tokens, mask_t

    def rerank(
        self,
        queries: Sequence[str],
        candidates: List[List[str]],
        *,
        top_k: Optional[int] = None,
    ) -> List[List[int]]:
        """Rerank per-query candidate texts; returns per-query orderings
        (indices into the candidate list, best first).

        The per-doc token budget is `budget_tokens // max(m, 1)`, clamped
        to the encoder window (parity: qdrant_handler.py:375).
        """
        q = len(queries)
        m = max((len(c) for c in candidates), default=0)
        if m == 0:
            return [[] for _ in queries]
        per_doc = max(16, min(self.embedder.max_len,
                              self.budget_tokens // m))
        q_tokens, q_mask = self._encode_tokens(
            queries, min(64, self.embedder.max_len))

        flat_docs: List[str] = []
        for c in candidates:
            flat_docs.extend(c + [""] * (m - len(c)))
        d_tokens, d_mask = self._encode_tokens(flat_docs, per_doc)
        td, dim = d_tokens.shape[-2], d_tokens.shape[-1]
        d_tokens = d_tokens.reshape(q, m, td, dim)
        d_mask = d_mask.reshape(q, m, td)
        # padded candidate slots must not outrank real ones
        real = np.zeros((q, m), dtype=bool)
        for i, c in enumerate(candidates):
            real[i, : len(c)] = True
        d_mask = d_mask & torch.from_numpy(real).to(d_mask.device)[:, :, None]

        scores = maxsim_scores(q_tokens, q_mask, d_tokens, d_mask)
        scores = np.where(real, scores.cpu().numpy(), -np.inf)
        order = np.argsort(-scores, axis=-1)
        out = []
        for i, c in enumerate(candidates):
            ranked = [int(j) for j in order[i] if j < len(c)]
            out.append(ranked[: top_k or len(c)])
        return out
