"""ctypes binding for the native WordPiece fast path (wordpiece.c).

Copy of `rag_application_tpu/native/wordpiece_lib.py`.

`NativeWordPiece` mirrors the encode surface of
models.wordpiece.WordPieceTokenizer for ASCII inputs; rows the C side
rejects (any byte >= 0x80) are reported so the caller can re-encode them
with the Python implementation. See wordpiece.c for scope notes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import build_lib

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "wordpiece.c")
_SO = os.path.join(_DIR, "libwordpiece.so")
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_lib(_SRC, _SO))
    lib.wp_new.restype = ctypes.c_void_p
    lib.wp_new.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_pad_id.restype = ctypes.c_int32
    lib.wp_pad_id.argtypes = [ctypes.c_void_p]
    lib.wp_encode.restype = ctypes.c_int64
    lib.wp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeWordPiece:
    """C-backed WordPiece over an id-ordered vocab dict."""

    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True):
        lib = load()
        # '\n'-joined tokens in id order; ids are line numbers, so gaps
        # are represented as blank lines (they consume an id like the
        # python loader's enumerate()).
        size = max(vocab.values()) + 1 if vocab else 0
        rows = [""] * size
        for tok, i in vocab.items():
            rows[i] = tok
        blob = "\n".join(rows).encode("utf-8")
        self._lib = lib
        self._h = lib.wp_new(blob, len(blob), 1 if lowercase else 0)
        if not self._h:
            raise MemoryError("wp_new failed")
        self.pad_id = int(lib.wp_pad_id(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wp_free(h)
            self._h = None

    def encode(self, text: str, max_len: int) -> Optional[List[int]]:
        """ids for one text, or None if the text needs the python path."""
        max_len = max(2, max_len)
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return None
        out = np.empty(max_len, dtype=np.int32)
        n = self._lib.wp_encode(
            self._h, raw, len(raw), np.int32(max_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n < 0:
            return None
        return out[:n].tolist()

    def encode_batch(
        self, texts: Sequence[str], max_len: int
    ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """(ids (N, max_len) pad-filled, lens (N,), fallback_rows).

        fallback_rows lists indices the C side rejected (non-ASCII);
        their ids rows are untouched pad and must be overwritten by the
        caller with the python encoder's output.
        """
        max_len = max(2, max_len)
        n = len(texts)
        ids = np.full((n, max_len), self.pad_id, dtype=np.int32)
        lens = np.zeros(n, dtype=np.int64)
        fallback: List[int] = []
        encoded = []
        offsets = np.zeros(n + 1, dtype=np.int64)
        for i, t in enumerate(texts):
            try:
                b = t.encode("ascii")
            except UnicodeEncodeError:
                b = b"\xff"  # force the C side to mark the row
            encoded.append(b)
            offsets[i + 1] = offsets[i] + len(b)
        buf = b"".join(encoded)
        self._lib.wp_encode_batch(
            self._h, buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            np.int64(n), np.int32(max_len),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        for i in range(n):
            if lens[i] < 0:
                fallback.append(i)
                lens[i] = 0
        return ids, lens, fallback
