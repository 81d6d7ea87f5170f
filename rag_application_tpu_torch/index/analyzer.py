"""Text analysis for BM25: tokenize -> normalize -> term ids.

Copy of `rag_application_tpu/index/analyzer.py`.

Parity target: fastembed's "Qdrant/bm25" text pipeline (lowercase,
punctuation split, English stopword removal, Snowball stemming) used by
the reference's sparse embedding path (app/core/embedding/
embedding_handler.py:41,101-142). We implement lowercase + alnum
tokenization + the same stopword family + a light suffix stemmer. The
vocabulary is a host dict assigning consecutive term ids, which doubles
as the posting-row map for the device arrays.
"""

from __future__ import annotations

import re
from typing import Dict, List

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# The classic English stopword list (Lucene/fastembed family).
STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)

_SUFFIXES = ("ational", "iveness", "fulness", "ousness", "ization", "ations",
             "ingly", "ements", "ments", "ation", "ness", "ing", "ies",
             "ied", "ed", "es", "s")


def light_stem(token: str) -> str:
    """Cheap suffix stemmer approximating Snowball for retrieval purposes."""
    if len(token) <= 3:
        return token
    for suf in _SUFFIXES:
        if token.endswith(suf) and len(token) - len(suf) >= 3:
            stem = token[: -len(suf)]
            if suf in ("ies", "ied"):
                stem += "i"
            return stem
    return token


class Analyzer:
    """Tokenizer + incremental vocabulary.

    Term ids are consecutive ints in insertion order; the id is also the
    row of the term in the device posting arrays.
    """

    def __init__(self, *, stem: bool = True, stopwords: bool = True):
        self.stem = stem
        self.stopwords = stopwords
        self.vocab: Dict[str, int] = {}

    def tokenize(self, text: str) -> List[str]:
        tokens = _TOKEN_RE.findall(text.lower())
        if self.stopwords:
            tokens = [t for t in tokens if t not in STOPWORDS]
        if self.stem:
            tokens = [light_stem(t) for t in tokens]
        return tokens

    def encode(self, text: str, *, grow: bool) -> List[int]:
        """Text -> term ids. ``grow=True`` adds unseen terms to the vocab
        (indexing); ``grow=False`` drops them (queries)."""
        out = []
        for tok in self.tokenize(text):
            tid = self.vocab.get(tok)
            if tid is None:
                if not grow:
                    continue
                tid = len(self.vocab)
                self.vocab[tok] = tid
            out.append(tid)
        return out

    def __len__(self) -> int:
        return len(self.vocab)
