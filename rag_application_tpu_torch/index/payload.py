"""Host-side payload store + filter bitmaps.

Copy of `rag_application_tpu/index/payload.py` (numpy and the standard
library only).

The reference keeps chunk payloads (text, context, document_id, chunk
metadata) inside Qdrant points and filters server-side by user/document
fields (qdrant_handler.py:120-198,297). Here payloads live on the host,
aligned with index rows; filtering compiles to corpus-aligned boolean
masks handed to the device kernels. Masks are cached per filter key and
invalidated on mutation.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

import numpy as np


class PayloadStore:
    def __init__(self):
        self._payloads: List[Optional[Dict[str, Any]]] = []
        # inverted maps for the common filter fields
        self._by_field: Dict[str, Dict[Any, Set[int]]] = {}
        self._mask_cache: Dict[tuple, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._payloads)

    def add(self, payloads: Sequence[Dict[str, Any]]) -> List[int]:
        rows = []
        for p in payloads:
            row = len(self._payloads)
            self._payloads.append(dict(p))
            for key, val in p.items():
                if isinstance(val, (str, int, bool)):
                    self._by_field.setdefault(key, {}).setdefault(val, set()).add(row)
            rows.append(row)
        self._mask_cache.clear()
        return rows

    def get(self, row: int) -> Optional[Dict[str, Any]]:
        if 0 <= row < len(self._payloads):
            return self._payloads[row]
        return None

    def get_many(self, rows: Iterable[int]) -> List[Optional[Dict[str, Any]]]:
        return [self.get(r) for r in rows]

    def delete(self, rows: Iterable[int]) -> None:
        # buckets are sets: discard is O(1) (list buckets made deleting a
        # large document quadratic in its chunk count)
        for row in rows:
            p = self._payloads[row]
            if p is None:
                continue
            for key, val in p.items():
                bucket = self._by_field.get(key, {}).get(val)
                if bucket is not None:
                    bucket.discard(row)
            self._payloads[row] = None
        self._mask_cache.clear()

    def rows_where(self, **conditions) -> List[int]:
        """Rows whose payload matches all equality conditions."""
        result: Optional[set] = None
        for key, val in conditions.items():
            rows = set(self._by_field.get(key, {}).get(val, ()))
            result = rows if result is None else (result & rows)
            if not result:
                return []
        return sorted(result or ())

    def filter_mask(self, capacity: int, **conditions) -> Optional[np.ndarray]:
        """(capacity,) bool mask for the given equality conditions.

        Returns None when no conditions are given (no filtering).
        """
        if not conditions:
            return None
        key = (capacity,) + tuple(sorted(conditions.items()))
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        mask = np.zeros(capacity, dtype=bool)
        rows = self.rows_where(**conditions)
        if rows:
            mask[np.asarray(rows)] = True
        self._mask_cache[key] = mask
        return mask

    # -------------------------------------------------------- serialization

    def to_state(self) -> dict:
        return {"payloads": self._payloads}

    @classmethod
    def from_state(cls, state: dict) -> "PayloadStore":
        store = cls()
        for p in state["payloads"]:
            if p is None:
                store._payloads.append(None)
            else:
                store.add([p])
        # preserve row alignment for deleted rows
        return store
