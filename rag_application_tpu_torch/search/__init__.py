from .fused import FusedSearcher, FusedSpec, fused_core
from .hybrid import HybridSearcher, hybrid_search
from .params import adaptive_funnel

__all__ = ["FusedSearcher", "FusedSpec", "fused_core", "HybridSearcher",
           "hybrid_search", "adaptive_funnel"]
