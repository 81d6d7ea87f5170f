"""ctypes wrapper exposing the C analyzer with the Python Analyzer API.

Copy of `rag_application_tpu/index/native_analyzer.py`.

Drop-in for `index.analyzer.Analyzer` (same vocabulary semantics:
insertion-ordered consecutive ids). `make_analyzer()` picks the native
implementation when the toolchain can build it and falls back to pure
Python otherwise — ingest code never needs to care.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

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
        blobs = [t.encode("utf-8", errors="ignore") for t in texts]
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        buf = b"".join(blobs)
        cap = max(16, len(buf) // 2 + 8 * len(blobs) + 8)
        out_ids = np.empty(cap, dtype=np.int32)
        out_offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        total = self._lib.analyzer_encode_batch(
            self._h, buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(blobs), int(grow),
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out_ids[:total].copy(), out_offsets

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


def make_analyzer(*, stem: bool = True, stopwords: bool = True,
                  prefer_native: bool = True):
    """Native analyzer when buildable, Python otherwise."""
    if prefer_native and native.available():
        return NativeAnalyzer(stem=stem, stopwords=stopwords)
    return Analyzer(stem=stem, stopwords=stopwords)
