from .collection import Collection, SearchHit, VectorStore
from .objects import NoSuchKeyError, ObjectStore

__all__ = ["Collection", "NoSuchKeyError", "ObjectStore", "SearchHit",
           "VectorStore"]
