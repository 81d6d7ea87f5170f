from .collection import Collection, SearchHit, VectorStore

__all__ = ["Collection", "SearchHit", "VectorStore"]
