from .topk import blocked_topk, gather_rescore, merge_topk, stable_topk
from .quant import (
    dequantize_int8,
    matryoshka_inv_norms,
    prepare_vectors,
    prepare_vectors_into,
    prepare_vectors_plain,
    prepare_vectors_xla,
    quantize_int8,
)
from .bm25 import (
    bm25_impact_weights,
    bm25_match_rows,
    bm25_match_scores,
    bm25_topk,
    pack_doc_major,
)
from .rrf import INVALID_ID, first_occurrence_mask, rrf_fuse
from .fused_topk import fused_scan_topk, scan_sheet

__all__ = [
    "blocked_topk",
    "gather_rescore",
    "merge_topk",
    "stable_topk",
    "quantize_int8",
    "dequantize_int8",
    "matryoshka_inv_norms",
    "prepare_vectors",
    "prepare_vectors_into",
    "prepare_vectors_plain",
    "prepare_vectors_xla",
    "bm25_impact_weights",
    "bm25_match_rows",
    "bm25_match_scores",
    "bm25_topk",
    "pack_doc_major",
    "INVALID_ID",
    "first_occurrence_mask",
    "rrf_fuse",
    "fused_scan_topk",
    "scan_sheet",
]
