from .analyzer import Analyzer
from .dense import DenseIndex
from .sparse import SparseIndex

__all__ = ["Analyzer", "DenseIndex", "SparseIndex"]
