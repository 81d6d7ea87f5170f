"""ctypes wrapper exposing the C analyzer with the Python Analyzer API.

Copy of `rag_application_tpu/index/native_analyzer.py`, with one added
method, `encode_queries` (the C pass from a batch of query texts to
fixed-width term rows); the other methods keep the copy's semantics.

Drop-in for `index.analyzer.Analyzer` (same vocabulary semantics:
insertion-ordered consecutive ids). `make_analyzer()` picks the native
implementation when the toolchain can build it and falls back to pure
Python otherwise — ingest code never needs to care.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native
from .analyzer import Analyzer


class NativeAnalyzer:
    def __init__(self, *, stem: bool = True, stopwords: bool = True):
        self.stem = stem
        self.stopwords = stopwords
        self._lib = native.load()
        self._h = self._lib.analyzer_new(int(stem), int(stopwords))

    def __del__(self):  # pragma: no cover
        try:
            self._lib.analyzer_free(self._h)
        except Exception:
            pass

    def __len__(self) -> int:
        return int(self._lib.analyzer_vocab_size(self._h))

    # Python-Analyzer-compatible vocab view (used by checkpointing)
    @property
    def vocab(self) -> Dict[str, int]:
        return {
            self._lib.analyzer_term(self._h, i).decode(): i
            for i in range(len(self))
        }

    @vocab.setter
    def vocab(self, mapping: Dict[str, int]) -> None:
        if len(self):
            raise ValueError("vocab import requires a fresh analyzer")
        for term, tid in sorted(mapping.items(), key=lambda kv: kv[1]):
            got = self._lib.analyzer_intern(self._h, term.encode())
            if got != tid:
                raise ValueError(f"non-contiguous vocab ids at {term}")

    def encode(self, text: str, *, grow: bool) -> List[int]:
        data = text.encode("utf-8", errors="ignore")
        cap = max(16, len(data) // 2 + 8)
        out = (ctypes.c_int32 * cap)()
        n = self._lib.analyzer_encode(self._h, data, len(data), int(grow),
                                      out, cap)
        return list(out[:n])

    def encode_batch(self, texts: Sequence[str], *, grow: bool):
        """Vectorized batch encode -> (flat ids int32, offsets int64)."""
        buf, offsets = _pack(texts)
        n = len(offsets) - 1
        cap = max(16, len(buf) // 2 + 8 * n + 8)
        out_ids = np.empty(cap, dtype=np.int32)
        out_offsets = np.zeros(n + 1, dtype=np.int64)
        total = self._lib.analyzer_encode_batch(
            self._h, buf, _ptr(offsets, ctypes.c_int64), n, int(grow),
            _ptr(out_ids, ctypes.c_int32), cap,
            _ptr(out_offsets, ctypes.c_int64),
        )
        return out_ids[:total].copy(), out_offsets

    def encode_queries(self, texts: Sequence[str], t: int, pad_row: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Query texts -> (rows, terms, valid), each (n, t): a query's
        known terms (unseen ones dropped, the vocabulary left as it is),
        each once in first-occurrence order, at most ``t``; the rest of
        its row is ``pad_row``, -2 and False. One C call, without the
        interpreter lock, so threads may encode at once."""
        buf, offsets = _pack(texts)
        n = len(offsets) - 1
        rows = np.empty((n, t), dtype=np.int32)
        terms = np.empty((n, t), dtype=np.int32)
        valid = np.empty((n, t), dtype=np.bool_)
        self._lib.analyzer_encode_queries(
            self._h, buf, _ptr(offsets, ctypes.c_int64), n, t, pad_row,
            _ptr(rows, ctypes.c_int32), _ptr(terms, ctypes.c_int32),
            _ptr(valid, ctypes.c_uint8),
        )
        return rows, terms, valid

    def tokenize(self, text: str) -> List[str]:
        # side-effect free like Analyzer.tokenize (the previous grow=True
        # round-trip interned every query term, bloating the vocabulary
        # and potentially doubling v_pad -> full postings rebuild).
        # Diagnostic surface, so the pure-Python pipeline is fine here.
        from .analyzer import _TOKEN_RE, STOPWORDS, light_stem

        tokens = _TOKEN_RE.findall(text.lower())
        if self.stopwords:
            tokens = [t for t in tokens if t not in STOPWORDS]
        if self.stem:
            tokens = [light_stem(t) for t in tokens]
        return tokens


def _pack(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """Texts as one UTF-8 blob and its n + 1 byte offsets."""
    blobs = [t.encode("utf-8", errors="ignore") for t in texts]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return b"".join(blobs), offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def make_analyzer(*, stem: bool = True, stopwords: bool = True,
                  prefer_native: bool = True):
    """Native analyzer when buildable, Python otherwise."""
    if prefer_native and native.available():
        return NativeAnalyzer(stem=stem, stopwords=stopwords)
    return Analyzer(stem=stem, stopwords=stopwords)
