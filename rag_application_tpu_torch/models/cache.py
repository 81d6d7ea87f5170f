"""Host-side embedding cache.

Copy of `rag_application_tpu/models/cache.py` (numpy and the standard
library only).

Parity: the reference caches embeddings in Redis keyed
`embedding:{type}:{provider}:{model}:{sha256(text)}` with TTL 3600
(app/core/embedding/embedding_handler.py:52-69; app/core/cache/
redis_cache.py:19-48). Here the cache is an in-process LRU in front of
batched encoder forward passes — the misses of a batch are encoded in
one device call, hits skip the device entirely.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Optional

import numpy as np


class EmbeddingCache:
    def __init__(self, capacity: int = 65536, ttl: float = 3600.0,
                 model_tag: str = "default"):
        self.capacity = capacity
        self.ttl = ttl
        self.model_tag = model_tag
        self._store: "OrderedDict[str, tuple[float, np.ndarray]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def key(self, text: str) -> str:
        h = hashlib.sha256(text.encode()).hexdigest()
        return f"embedding:dense:{self.model_tag}:{h}"

    def get(self, text: str) -> Optional[np.ndarray]:
        k = self.key(text)
        entry = self._store.get(k)
        if entry is None:
            self.misses += 1
            return None
        ts, vec = entry
        if self.ttl and time.monotonic() - ts > self.ttl:
            del self._store[k]
            self.misses += 1
            return None
        self._store.move_to_end(k)
        self.hits += 1
        return vec

    def clear(self) -> None:
        """Drop every entry (e.g. after the encoder's weights change)."""
        self._store.clear()

    def put(self, text: str, vec: np.ndarray) -> None:
        k = self.key(text)
        # copy: callers pass views into whole batch arrays — asarray
        # would pin the full (batch, dim) parent per cached row
        self._store[k] = (time.monotonic(), np.array(vec, copy=True))
        self._store.move_to_end(k)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def purge(self) -> None:
        """Parity: RedisCache.purge_cache."""
        self._store.clear()

    def __len__(self) -> int:
        return len(self._store)
