"""Native (C) components, loaded via ctypes.

Copy of `rag_application_tpu/native/__init__.py` (the analyzer; the
WordPiece binding is `wordpiece_lib.py`).

The shared library is built lazily on first use with the system
compiler (cc/g++ are part of the target image; pybind11 is not, hence
ctypes). Build artifacts land next to the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "analyzer.c")
_SO = os.path.join(_DIR, "libanalyzer.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _src_digest(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def build_lib(src: str, so: str, force: bool = False) -> str:
    """Compile one C source into a shared library.

    Staleness is decided by a content hash of the source recorded in a
    sidecar file, not mtime: a fresh checkout gives .c and a stale .so
    identical mtimes, which would silently load outdated code.
    """
    stamp = so + ".sha256"
    with _lock:
        digest = _src_digest(src)
        current = None
        if os.path.exists(stamp):
            try:
                with open(stamp) as f:
                    current = f.read().strip()
            except OSError:
                current = None
        if force or not os.path.exists(so) or current != digest:
            # pid-unique temp names: concurrent test processes (pytest
            # -n / xdist) may build the same .so at once — os.replace
            # keeps the winner atomic either way
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["cc", "-O3", "-fPIC", "-shared", "-o", tmp, src],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
            with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
                f.write(digest)
            os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
    return so


def build(force: bool = False) -> str:
    """Compile the native analyzer; returns the .so path."""
    return build_lib(_SRC, _SO, force)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, declaring signatures."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    lib = ctypes.CDLL(path)
    lib.analyzer_new.restype = ctypes.c_void_p
    lib.analyzer_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.analyzer_free.argtypes = [ctypes.c_void_p]
    lib.analyzer_vocab_size.restype = ctypes.c_int64
    lib.analyzer_vocab_size.argtypes = [ctypes.c_void_p]
    lib.analyzer_term.restype = ctypes.c_char_p
    lib.analyzer_term.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.analyzer_intern.restype = ctypes.c_int32
    lib.analyzer_intern.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.analyzer_encode.restype = ctypes.c_int64
    lib.analyzer_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.analyzer_encode_batch.restype = ctypes.c_int64
    lib.analyzer_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
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
