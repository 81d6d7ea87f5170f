from .fused import FusedSearcher, FusedSpec, fused_core

__all__ = ["FusedSearcher", "FusedSpec", "fused_core"]
