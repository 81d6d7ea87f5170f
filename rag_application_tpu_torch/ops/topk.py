"""Top-k, blocked similarity search and exact rescore.

Port of `rag_application_tpu/ops/topk.py`. Every top-k in the port goes
through `stable_topk`: `jax.lax.top_k` breaks ties toward the lower
index, `torch.topk` does not, and the int8 scan's integer scores tie
often. `jax.lax.approx_max_k` is exact on the CPU backend the reference
is checked on, so the port's `approx` switches select the same exact
top-k.

Float32 products run in full float32 (TF32 off, `full_f32_matmul`), the
precision the JAX package requests with `preferred_element_type`; bf16
operands are upcast before the product, since a bf16 x bf16 `matmul`
returns bf16 in PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import cdiv, full_f32_matmul

NEG_INF = float("-inf")


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties toward the lower index
    (`jax.lax.top_k` order). Returns (values, int64 positions)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two per-query candidate lists into the top-k of their union.
    (Q, Ka) + (Q, Kb) -> (Q, k); does not deduplicate ids."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    top_vals, top_pos = stable_topk(vals, k)
    return top_vals, torch.gather(idx, -1, top_pos)


def dot_scores(queries: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (B, d) -> (Q, B) scores: int32 for int8 x int8, else f32.

    CUDA has no int8 `matmul`, so the int8 sums go through floats and are
    exact there: f32 holds them while d*127^2 < 2^24 (d <= 1040), f64
    beyond. Float operands are upcast to f32 before the product."""
    if block.dtype == torch.int8:
        exact = torch.float32 if block.shape[1] * 127 * 127 < (1 << 24) \
            else torch.float64
        with full_f32_matmul():
            s = queries.to(exact) @ block.to(exact).T
        return s.to(torch.int32)
    with full_f32_matmul():
        return queries.float() @ block.float().T


def blocked_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    block_size: int = 131072,
    valid_n: Optional[int] = None,
    prefix_dim: Optional[int] = None,
    inv_norms: Optional[torch.Tensor] = None,
    filter_mask: Optional[torch.Tensor] = None,
    approx: bool = True,
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search of ``queries`` against ``corpus`` in
    corpus blocks with a running merge. Returns (values (Q, k) f32,
    indices (Q, k) int32) sorted descending; rows >= valid_n and
    filtered rows score -inf. ``approx``/``recall_target`` are accepted
    for signature parity and select the exact top-k (see module doc)."""
    del approx, recall_target
    n, d = corpus.shape
    q = queries.shape[0]
    if valid_n is None:
        valid_n = n
    if prefix_dim is not None and prefix_dim < d:
        corpus = corpus[:, :prefix_dim]
        queries = queries[:, :prefix_dim]
    k_eff = min(k, n)
    num_blocks = cdiv(n, block_size)
    padded_n = num_blocks * block_size
    dev = corpus.device

    def score_block(start: int) -> torch.Tensor:
        scores = dot_scores(queries, corpus[start:start + block_size]).float()
        valid = start + torch.arange(block_size, device=dev) < valid_n
        if inv_norms is not None:
            scores = scores * inv_norms[start:start + block_size][None, :]
        if filter_mask is not None:
            valid = valid & filter_mask[start:start + block_size]
        return torch.where(valid[None, :], scores, NEG_INF)

    if num_blocks == 1 and padded_n == n:
        vals, pos = stable_topk(score_block(0), k_eff)
        return vals, pos.to(torch.int32)

    # pad once so every block has block_size rows (padding scores -inf and
    # keeps the reference's ids for -inf slots)
    pad = padded_n - n
    if pad:
        corpus = torch.nn.functional.pad(corpus, (0, 0, 0, pad))
        if inv_norms is not None:
            inv_norms = torch.nn.functional.pad(inv_norms, (0, pad))
        if filter_mask is not None:
            filter_mask = torch.nn.functional.pad(filter_mask, (0, pad))

    vals = torch.full((q, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((q, k_eff), dtype=torch.int32, device=dev)
    for b in range(num_blocks):
        start = b * block_size
        b_vals, b_pos = stable_topk(score_block(start), k_eff)
        vals, idx = merge_topk(vals, idx, b_vals,
                               (b_pos + start).to(torch.int32), k_eff)
    return vals, idx


def gather_rescore(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    candidates: torch.Tensor,
    *,
    candidate_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact f32 rescore of candidate rows: (N, d), (Q, d), (Q, m) ids ->
    (Q, m) scores; invalid candidates -> -inf."""
    cand_vecs = corpus[candidates.long()].float()  # (Q, m, d)
    with full_f32_matmul():
        scores = torch.einsum("qd,qmd->qm", queries.float(), cand_vecs)
    if candidate_valid is not None:
        scores = torch.where(candidate_valid, scores, NEG_INF)
    return scores
