"""Text chunking.

Copy of `rag_application_tpu/ingest/chunker.py`.

Parity targets:
  * v2 direct-text path: 8000-char word packing — split on whitespace,
    pack words greedily up to the budget (IndexerAPI/src/core/processors/
    file_processor.py:223-241).
  * v1 path: chunk_size/chunk_overlap config with title-ish boundaries
    (UnstructuredLoader by_title, max_characters=0.75*chunk_size,
    app/services/file_processor/text_processor.py:154-162;
    app/config.py chunk knobs).
"""

from __future__ import annotations

import re
from typing import List


def chunk_words(text: str, max_chars: int = 8000) -> List[str]:
    """Greedy word packing (parity: file_processor.py:223-241): words are
    never split; each chunk is the longest run of words fitting the
    budget. A single over-long word becomes its own chunk."""
    words = text.split()
    chunks: List[str] = []
    cur: List[str] = []
    cur_len = 0
    for w in words:
        add = len(w) + (1 if cur else 0)
        if cur and cur_len + add > max_chars:
            chunks.append(" ".join(cur))
            cur, cur_len = [], 0
            add = len(w)
        cur.append(w)
        cur_len += add
    if cur:
        chunks.append(" ".join(cur))
    return chunks


_HEADING_RE = re.compile(r"^(#{1,6}\s|\d+[.)]\s+[A-Z]|[A-Z][A-Z \t]{4,}$)")


def chunk_text(
    text: str,
    chunk_size: int = 1000,
    chunk_overlap: int = 200,
    *,
    by_title: bool = True,
) -> List[str]:
    """Boundary-aware chunking with overlap (v1 parity).

    Splits into paragraphs, starts a new chunk at headings (`by_title`),
    packs paragraphs up to `0.75*chunk_size` characters (the reference's
    max_characters rule), and prefixes each non-first chunk with the last
    `chunk_overlap` characters of its predecessor.
    """
    max_chars = int(0.75 * chunk_size)
    paras = [p for p in re.split(r"\n\s*\n", text) if p.strip()]
    chunks: List[str] = []
    cur = ""
    for para in paras:
        is_heading = by_title and bool(_HEADING_RE.match(para.strip()))
        if cur and (is_heading or len(cur) + len(para) + 2 > max_chars):
            chunks.append(cur)
            cur = ""
        for piece in chunk_words(para, max_chars):
            if cur and len(cur) + len(piece) + 2 > max_chars:
                chunks.append(cur)
                cur = ""
            cur = f"{cur}\n\n{piece}" if cur else piece
    if cur:
        chunks.append(cur)
    if chunk_overlap > 0 and len(chunks) > 1:
        out = [chunks[0]]
        for prev, nxt in zip(chunks, chunks[1:]):
            out.append(prev[-chunk_overlap:] + nxt)
        return out
    return chunks
