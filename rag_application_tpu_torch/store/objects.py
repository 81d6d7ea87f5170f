"""Filesystem-backed object store with S3 semantics.

Copy of `rag_application_tpu/store/objects.py`.

Parity: IndexerAPI/src/core/storage/s3_handler.py:14-254 — the aiobotocore
MinIO client the reference uses for bulk payload handoff between fan-out
stages (original uploads, per-page PDFs, page JPEGs) and for the delete
cascade (`delete_prefix`). Here the store is a local directory tree
(bucket/key -> file), which keeps the same call surface so a real S3
client can be swapped in behind it:

    put_object / get_object / object_exists / delete_object
    delete_prefix / list_objects / build_document_base_path

Keys are sanitized against path traversal (every segment is resolved
inside the bucket root). Writes are atomic (tmp file + rename) so a
crashed ingest never leaves a partial object for the retry to read.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import threading
from pathlib import Path
from typing import List, Optional


class NoSuchKeyError(KeyError):
    """Missing object (parity: botocore NoSuchKey — the reference treats
    it as non-retryable, rabbitmq_handler.py:37-63)."""


def _safe_relpath(root: Path, key: str) -> Path:
    """Resolve `key` strictly inside `root` (reject traversal/absolute)."""
    key = key.lstrip("/")
    if not key:
        raise ValueError("empty object key")
    p = (root / key).resolve()
    if not p.is_relative_to(root.resolve()):
        raise ValueError(f"object key escapes bucket root: {key!r}")
    return p


class ObjectStore:
    """Directory-tree object store: `base_dir/<bucket>/<key>`."""

    def __init__(self, base_dir: str | Path, *, default_bucket: str = "documents"):
        self.base = Path(base_dir)
        self.default_bucket = default_bucket
        self._lock = threading.Lock()
        self.base.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- buckets

    def _bucket_root(self, bucket: Optional[str]) -> Path:
        """Bucket auto-create (parity: s3_handler.py:37-50)."""
        root = self.base / (bucket or self.default_bucket)
        if not root.exists():
            with self._lock:
                root.mkdir(parents=True, exist_ok=True)
        return root

    # ------------------------------------------------------------- objects

    def put_object(self, key: str, data: bytes, *,
                   bucket: Optional[str] = None) -> str:
        root = self._bucket_root(bucket)
        path = _safe_relpath(root, key)
        path.parent.mkdir(parents=True, exist_ok=True)
        # atomic publish: a reader never observes a half-written object
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return key

    def get_object(self, key: str, *, bucket: Optional[str] = None) -> bytes:
        path = _safe_relpath(self._bucket_root(bucket), key)
        try:
            return path.read_bytes()
        except FileNotFoundError:
            raise NoSuchKeyError(key) from None

    def object_exists(self, key: str, *, bucket: Optional[str] = None) -> bool:
        return _safe_relpath(self._bucket_root(bucket), key).is_file()

    def delete_object(self, key: str, *, bucket: Optional[str] = None) -> bool:
        path = _safe_relpath(self._bucket_root(bucket), key)
        try:
            path.unlink()
            return True
        except FileNotFoundError:
            return False

    def delete_prefix(self, prefix: str, *, bucket: Optional[str] = None) -> int:
        """Delete every object whose KEY starts with `prefix` — true S3
        string-prefix semantics ('a/b' also matches key 'a/bc/d'), so a
        real S3 client can swap in without changing the delete-cascade
        scope. Returns the number of files actually removed (in-flight
        .tmp- files included, unlike list_objects). Parity: the document
        delete cascade, s3_handler delete-prefix + delete.py:10-60."""
        root = self._bucket_root(bucket)
        if not root.is_dir():
            return 0
        n = 0
        doomed_dirs = []
        for p in sorted(root.rglob("*"), reverse=True):
            rel = str(p.relative_to(root))
            if not rel.startswith(prefix):
                continue
            if p.is_file():
                try:
                    p.unlink()
                    n += 1
                except FileNotFoundError:
                    pass
            elif p.is_dir():
                doomed_dirs.append(p)
        for d in doomed_dirs:  # already deepest-first (reverse sort)
            try:
                d.rmdir()
            except OSError:
                pass  # something outside the prefix still lives in it
        return n

    def list_objects(self, prefix: str = "", *,
                     bucket: Optional[str] = None) -> List[str]:
        root = self._bucket_root(bucket)
        base = _safe_relpath(root, prefix) if prefix else root
        if base.is_file():
            return [str(base.relative_to(root))]
        if not base.is_dir():
            return []
        return sorted(
            str(p.relative_to(root))
            for p in base.rglob("*")
            if p.is_file() and not p.name.startswith(".tmp-")
        )

    # ------------------------------------------------------- async wrappers

    async def aput_object(self, key: str, data: bytes, *,
                          bucket: Optional[str] = None) -> str:
        return await asyncio.to_thread(self.put_object, key, data, bucket=bucket)

    async def aget_object(self, key: str, *,
                          bucket: Optional[str] = None) -> bytes:
        return await asyncio.to_thread(self.get_object, key, bucket=bucket)

    async def adelete_prefix(self, prefix: str, *,
                             bucket: Optional[str] = None) -> int:
        return await asyncio.to_thread(self.delete_prefix, prefix, bucket=bucket)

    # ------------------------------------------------------------- helpers

    @staticmethod
    def build_document_base_path(user_id: str, document_id: str) -> str:
        """Parity: build_document_s3_base_path (s3_handler.py)."""
        return f"{user_id}/{document_id}"
