"""Configuration tree for the port.

Own copy of `rag_application_tpu/config.py` (standard library only), so the
port imports nothing of the JAX package. Field names and defaults are the
same; `FunnelConfig.scan_impl` values keep their JAX names — see
`search/fused.py` for what "xla" and "pallas" select in the port.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class IndexConfig:
    """Dense/sparse index parameters.

    Parity: v1 uses 768-d cosine with int8 + matryoshka {64,128,256} views
    (app/core/vector_store/qdrant/qdrant_handler.py:27,58-86,144-150); v2
    uses 2048-d multimodal (IndexerAPI/src/core/config.py:43). KG entity
    vectors are 256-d truncations (entity_relation_extractor.py:251).
    """

    dim: int = 768
    matryoshka_dims: Tuple[int, ...] = (64, 128, 256)
    # Storage planes. Dropping one trades capability for HBM capacity:
    #   store_int8=False  — no quantized scan table; the funnel must run
    #                       with quantized_limit=0 (bf16 scans only).
    #   store_bf16=False  — capacity mode: only the int8 table is kept
    #                       (769 B/row at 768-d vs 2308 with bf16), so a
    #                       16 GB chip holds 10M+ rows. Search scans int8
    #                       and the exact rescore reads dequantized int8
    #                       rows; matryoshka prefix views are unavailable.
    store_int8: bool = True
    store_bf16: bool = True
    # Capacity-mode per-row int8 scaling: rows quantize at 127/max|x|
    # with the reciprocal stored per row (+4 B/row), recovering ~7x
    # rescore resolution over the global /127 scale — the int8-rescore
    # precision floor that capped 10M recall at ~0.91. Full mode keeps
    # the global scale (its exact rescore reads the bf16 plane anyway).
    int8_per_row_scale: bool = True
    metric: str = "cosine"  # vectors are L2-normalized at insert
    # Device block size for scanned scoring kernels.
    block_size: int = 131072
    # Initial capacity; grows by doubling on insert overflow.
    initial_capacity: int = 4096
    # recall target handed to approx_max_k on the first cascade stage
    approx_recall_target: float = 0.95
    # Contiguous int8 copy of the normalized first-`scan_prefix_dim`
    # columns, used as the funnel's candidate-generation scan table.
    # The full-dim scan is MXU-bound (Q·N·d int8 MACs); a 128-d prefix
    # cuts both compute and HBM bytes 6x for d=768. 0 disables (scan the
    # full-dim int8 table). Must be a multiple of 128 (lane tiling).
    scan_prefix_dim: int = 0


@dataclass
class SparseConfig:
    """BM25 sparse retrieval parameters.

    Parity: the reference delegates BM25 to fastembed's "Qdrant/bm25"
    (app/core/embedding/embedding_handler.py:41,101-142) with Qdrant
    server-side IDF. k1/b are the fastembed defaults.
    """

    k1: float = 1.2
    b: float = 0.75
    # Postings per term kept on device (sorted by impact, truncated).
    # Impact-ordered truncation: only the top-P highest-impact postings of
    # a term can reach the candidate pool; low-idf (stopword-ish) terms
    # lose only negligible-weight postings.
    max_postings_per_term: int = 1024
    # Unique terms kept per document (for exact rescore), impact-ordered.
    max_terms_per_doc: int = 256
    # Query terms considered (padded/truncated).
    max_query_terms: int = 32
    # Candidates taken from the impact-ordered union before exact rescore.
    candidate_pool: int = 512
    # Vocabulary hashing space (term -> id via stable hash).
    vocab_size: int = 1 << 20


@dataclass
class FunnelConfig:
    """Hybrid-search candidate funnel.

    Parity with the reference's default funnel (matryoshka 100->80->60->40,
    int8 40, sparse 50, final 30; app/api/v1/endpoints/mcp/
    qdrant_search_mcp_endpoint.py:21-28) and its adaptive fallback
    (min(500,n/10)->min(400,n/15)->min(300,n/20)->min(200,n/25), sparse
    min(100,n/50); app/services/agents/hybrid_search_workflow.py:97-106).
    """

    matryoshka_limits: Tuple[int, ...] = (100, 80, 60)  # per matryoshka dim
    dense_limit: int = 40
    quantized_limit: int = 40
    sparse_limit: int = 50
    final_limit: int = 30
    rrf_k: int = 60  # Qdrant RRF constant
    # Final ranking of the deduped candidate union. "dense" = exact
    # dense rescore (Qdrant query_points parity — right when the
    # encoder is strong). "rrf" = reciprocal-rank fusion of the dense
    # ranking with the BM25 ranking — keyword hits survive a weak or
    # domain-shifted dense encoder. "dbsf" = distribution-based SCORE
    # fusion (Qdrant's DBSF mode): per-query min-max-normalized scores
    # summed — a leg with no score contrast (an untrained encoder)
    # cannot dilute a leg with a decisive winner (used by the
    # real-docs eval, r5).
    final_fusion: str = "dense"
    rerank: bool = False
    rerank_budget_tokens: int = 8000  # qdrant_handler.py:375
    # Scan-engine knobs. In the port "auto" = the fused CUDA scan kernel
    # on a CUDA index, the plain blocked_topk on a CPU index.
    scan_impl: str = "auto"
    scan_block_rows: int = 16384  # clamped by dim at resolve time
    scan_q_block: int = 1024      # ignored when batch <= q_block
    scan_approx_sheet: bool = True  # safe: exact rescore follows


@dataclass
class EncoderConfig:
    """JAX text-encoder config (768-d parity model)."""

    vocab_size: int = 30528
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 512
    out_dim: int = 768  # projected embedding dim (v1 parity)
    dtype: str = "bfloat16"
    cache_capacity: int = 65536  # host-side hash-keyed cache entries


@dataclass
class KGConfig:
    """Knowledge-graph store config.

    Parity: v1 entity/relationship vectors are 256-d (neo4j_handler.py:41);
    v2 keeps 4 vector spaces at 2048-d (IndexerAPI neo4j_handler.py:67-97).
    Traversal capped at 3 hops (AgentAPI queries.py:391,609); dedup
    threshold score>0.85 and string similarity>0.8 (deduplicator.py:35-43).
    """

    entity_dim: int = 256
    max_hops: int = 3
    max_degree: int = 32  # padded adjacency fixed degree
    dedup_score_threshold: float = 0.85
    dedup_string_threshold: float = 0.8


@dataclass
class IngestConfig:
    """Ingest pipeline config.

    Parity: 8000-char word packing (IndexerAPI file_processor.py:223-241),
    chunk overlap + context budgets (app/config.py), fan-out semaphore 10,
    <=5 retries (IndexerAPI/src/core/config.py:59-64).
    """

    chunk_chars: int = 8000
    chunk_overlap: int = 200
    max_concurrency: int = 10
    max_retries: int = 5
    encode_batch_size: int = 256
    # Directory for the filesystem object store (page-payload handoff +
    # original uploads, parity: MinIO/S3). Empty = inline payloads.
    object_store_dir: str = ""


@dataclass
class MeshConfig:
    """Device-mesh / sharding config."""

    # Axis names: data (query batch), shard (corpus rows), model (encoder TP)
    data_axis: str = "data"
    shard_axis: str = "shard"
    model_axis: str = "model"


@dataclass
class Config:
    index: IndexConfig = field(default_factory=IndexConfig)
    sparse: SparseConfig = field(default_factory=SparseConfig)
    funnel: FunnelConfig = field(default_factory=FunnelConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    kg: KGConfig = field(default_factory=KGConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def from_env(cls, prefix: str = "RAGTPU_") -> "Config":
        """Build a Config applying ``{prefix}{SECTION}_{FIELD}`` env overrides.

        e.g. RAGTPU_INDEX_DIM=2048 overrides Config.index.dim.
        """
        cfg = cls()
        for section_field in dataclasses.fields(cfg):
            section = getattr(cfg, section_field.name)
            for f in dataclasses.fields(section):
                key = f"{prefix}{section_field.name.upper()}_{f.name.upper()}"
                raw = os.environ.get(key)
                if raw is None:
                    continue
                typ = type(getattr(section, f.name))
                if typ is bool:
                    val = raw.lower() in ("1", "true", "yes")
                elif typ is tuple:
                    val = tuple(int(x) for x in raw.split(","))
                else:
                    val = typ(raw)
                setattr(section, f.name, val)
        return cfg


DEFAULT_CONFIG = Config()
