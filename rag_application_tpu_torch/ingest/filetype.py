"""Content-based file type detection (no external deps).

Copy of `rag_application_tpu/ingest/filetype.py`.

Parity: the reference sniffs the first 2 KB with python-magic before
routing (app/services/file_processor/file_processor.py:60-64) and runs
magika ML detection in v2 (IndexerAPI/src/core/processors/utils.py:68-79).
Here detection is magic numbers + content heuristics: enough to route the
same way (unstructured / structured / direct / image / media) even when
the filename lies or is missing.
"""

from __future__ import annotations

import io
import zipfile
from typing import Optional

# (magic bytes, mime) — distinctive multi-byte signatures, trusted
# unconditionally
_MAGIC = [
    (b"%PDF-", "application/pdf"),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"OggS", "audio/ogg"),
    (b"fLaC", "audio/flac"),
    (b"\x1a\x45\xdf\xa3", "video/x-matroska"),
    (b"PK\x03\x04", "application/zip"),  # refined below (xlsx/docx/pptx)
    (b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1", "application/vnd.ms-office"),
    (b"PAR1", "application/x-parquet"),
    (b"SQLite format 3\x00", "application/x-sqlite3"),
    (b"\x1f\x8b", "application/gzip"),
]

# short/ambiguous prefixes ('BM' also starts 'BM25 notes...'): only
# trusted when the payload does NOT look like text
_WEAK_MAGIC = [
    (b"BM", "image/bmp"),
    (b"\x00\x00\x01\x00", "image/x-icon"),
    (b"ID3", "audio/mpeg"),
    (b"\xff\xfb", "audio/mpeg"),
]

_ZIP_KINDS = {
    "xl/": "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet",
    "word/": "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    "ppt/": "application/vnd.openxmlformats-officedocument.presentationml.presentation",
}


def _riff_mime(head: bytes) -> Optional[str]:
    if head[:4] == b"RIFF" and len(head) >= 12:
        sub = head[8:12]
        if sub == b"WEBP":
            return "image/webp"
        if sub == b"WAVE":
            return "audio/wav"
        if sub == b"AVI ":
            return "video/x-msvideo"
    return None


def _mp4_mime(head: bytes) -> Optional[str]:
    if len(head) >= 12 and head[4:8] == b"ftyp":
        brand = head[8:12]
        if brand[:3] in (b"mp4", b"iso", b"M4V", b"avc", b"mmp"):
            return "video/mp4"
        if brand[:3] == b"M4A":
            return "audio/mp4"
        if brand == b"qt  ":
            return "video/quicktime"
        return "video/mp4"
    return None


def _zip_refine(data: bytes) -> str:
    """OOXML containers are zips — peek at member names."""
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            names = z.namelist()
    except Exception:
        return "application/zip"
    for prefix, mime in _ZIP_KINDS.items():
        if any(n.startswith(prefix) for n in names):
            return mime
    return "application/zip"


def _looks_like_csv(text: str) -> bool:
    """>= 2 lines agreeing on a delimiter count (>=1), like the sheet
    heuristics the reference applies (_structured_processor.py:158-172)."""
    lines = [ln for ln in text.splitlines() if ln.strip()][:10]
    if len(lines) < 2:
        return False
    for sep in (",", "\t", ";"):
        counts = [ln.count(sep) for ln in lines]
        if counts[0] >= 1 and len(set(counts)) == 1:
            return True
    return False


def detect_mime(data: bytes, filename: str = "") -> str:
    """Best-effort MIME from content (first 2 KB is enough, like the
    reference's `magic.from_buffer(content[:2048])`)."""
    head = data[:2048]
    for magic_bytes, mime in _MAGIC:
        if head.startswith(magic_bytes):
            if mime == "application/zip":
                return _zip_refine(data)
            return mime
    if (m := _riff_mime(head)) is not None:
        return m
    if (m := _mp4_mime(head)) is not None:
        return m
    # text vs binary: the reference's magic does the same split. NUL and
    # other control bytes are valid UTF-8, so decoding alone is not enough.
    def _weak_or(default: str) -> str:
        for magic_bytes, mime in _WEAK_MAGIC:
            if head.startswith(magic_bytes):
                return mime
        return default

    try:
        text = head.decode("utf-8")
    except UnicodeDecodeError:
        return _weak_or("application/octet-stream")
    if head:
        ctrl = sum(1 for b in head if b < 9 or 13 < b < 32)
        if ctrl / len(head) > 0.05:
            return _weak_or("application/octet-stream")
    stripped = text.lstrip()
    if stripped.startswith(("{", "[")):
        return "application/json"
    if stripped[:5].lower() in ("<html", "<!doc"):
        return "text/html"
    if _looks_like_csv(text):
        return "text/csv"
    if stripped.startswith("#") or filename.lower().endswith((".md", ".markdown")):
        return "text/markdown"
    return "text/plain"
