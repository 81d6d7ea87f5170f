"""Search-parameter policies.

Copy of `rag_application_tpu/search/params.py`; `FunnelConfig` is the
port's own (`config.py`).

The reference lets an LLM pick eight funnel parameters per query and falls
back to a corpus-size heuristic when the LLM call fails
(app/services/agents/hybrid_search_workflow.py:8-19,68-108). On TPU the
funnel sizes are compile-time constants, so the policy quantizes its
output to a small set of buckets — each bucket compiles once and is
reused. The LLM-in-the-loop variant stays host-side and optional (it just
returns one of these bucketed funnels).
"""

from __future__ import annotations

from ..config import FunnelConfig


def _bucket(x: int) -> int:
    """Round up to the nearest power of two to bound compile variants."""
    n = 8
    while n < x:
        n *= 2
    return n


def adaptive_funnel(corpus_size: int, base: FunnelConfig | None = None) -> FunnelConfig:
    """Corpus-size-adaptive funnel, parity with the reference fallback:
    matryoshka min(500,n/10) -> min(400,n/15) -> min(300,n/20), dense
    min(200,n/25), sparse min(100,n/50) (hybrid_search_workflow.py:97-106),
    bucketed to powers of two for compile-cache friendliness.
    """
    base = base or FunnelConfig()
    n = max(corpus_size, 1)
    if n < 5000:
        return base
    m1 = _bucket(min(500, n // 10))
    m2 = _bucket(min(400, n // 15))
    m3 = _bucket(min(300, n // 20))
    dense = _bucket(min(200, n // 25))
    sparse = _bucket(min(100, n // 50))
    return FunnelConfig(
        matryoshka_limits=(m1, m2, m3),
        dense_limit=dense,
        quantized_limit=dense,
        sparse_limit=sparse,
        final_limit=base.final_limit,
        rrf_k=base.rrf_k,
        final_fusion=base.final_fusion,
        rerank=base.rerank,
        rerank_budget_tokens=base.rerank_budget_tokens,
    )
