"""WordPiece tokenizer — drives imported HF BERT weights with real text.

Copy of `rag_application_tpu/models/wordpiece.py`.

The reference's HF local client tokenizes with `AutoTokenizer` before its
torch forward (app/core/models/huggingface/huggingface.py:165-170); the
framework's `models/bert.py` imports those checkpoints into JAX, so it
needs the matching tokenization. This is a dependency-free implementation
of BERT's pipeline — basic tokenization (clean, whitespace, punctuation,
CJK isolation, optional lowercase + accent stripping) followed by greedy
longest-match-first WordPiece — byte-for-byte parity-tested against
`transformers.BertTokenizer` in tests/test_wordpiece.py.

The hash tokenizer (models/tokenizer.py) stays the default for the
self-trained encoder; this one is for checkpoint parity.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_PAD, _UNK, _CLS, _SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicodedata does not
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


class WordPieceTokenizer:
    """BERT tokenization: basic tokenizer + WordPiece, HF-compatible."""

    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True,
                 max_len: int = 512, max_chars_per_word: int = 100,
                 native: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_len = max_len
        self.max_chars_per_word = max_chars_per_word
        self.unk_id = vocab.get(_UNK, 0)
        self.pad_id = vocab.get(_PAD, 0)
        self.cls_id = vocab.get(_CLS)
        self.sep_id = vocab.get(_SEP)
        self._native = None
        if native:
            try:
                from ..native.wordpiece_lib import NativeWordPiece

                self._native = NativeWordPiece(vocab, lowercase=lowercase)
            except Exception:  # no compiler / build failure: python path
                self._native = None

    # ---------------- construction ----------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def from_vocab_list(cls, tokens: Iterable[str], **kw) -> "WordPieceTokenizer":
        return cls({t: i for i, t in enumerate(tokens)}, **kw)

    # ---------------- basic tokenizer ----------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(word: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", word)
                       if unicodedata.category(ch) != "Mn")

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        # isolate CJK characters as their own tokens
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        words = "".join(spaced).split()
        out: List[str] = []
        for w in words:
            if self.lowercase:
                w = self._strip_accents(w.lower())
            # split on punctuation, keeping each mark as a token
            cur: List[str] = []
            for ch in w:
                if _is_punctuation(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    # ---------------- wordpiece ----------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [_UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [_UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for w in self.basic_tokenize(text):
            out.extend(self.wordpiece(w))
        return out

    # ---------------- model-facing API ----------------
    def token_ids(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]

    def encode(self, text: str, max_len: int | None = None) -> List[int]:
        """[CLS] body [SEP], truncated to max_len like HF's."""
        max_len = max_len or self.max_len
        ids = self.token_ids(text)[: max_len - 2]
        head = [self.cls_id] if self.cls_id is not None else []
        tail = [self.sep_id] if self.sep_id is not None else []
        return head + ids + tail

    def decode(self, ids: Sequence[int], *, skip_special: bool = True) -> str:
        """ids -> text: join ``##`` continuation pieces, space otherwise.
        Used by the local generation path (llm/local.py); lossy like any
        WordPiece round-trip (lowercasing, accent stripping)."""
        if not hasattr(self, "_inv_vocab"):
            self._inv_vocab = {i: t for t, i in self.vocab.items()}
        # only skip ids whose special token actually EXISTS: pad_id
        # defaults to 0 when the vocab has no [PAD], and skipping it
        # would silently drop the real token with id 0 from every decode
        special = {tid for name, tid in
                   ((_PAD, self.pad_id), (_CLS, self.cls_id),
                    (_SEP, self.sep_id))
                   if name in self.vocab and tid is not None}
        out: List[str] = []
        for i in ids:
            if skip_special and i in special:
                continue
            tok = self._inv_vocab.get(int(i), _UNK)
            if tok.startswith("##"):
                out.append(tok[2:])
            else:
                if out:
                    out.append(" ")
                out.append(tok)
        return "".join(out)

    def encode_batch(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded (ids, mask) int32/bool arrays for the encoder.

        Uses the native C fast path (native/wordpiece.c) when built:
        ASCII rows encode in C, anything else falls back to this python
        implementation row by row — identical output either way.

        The width is the batch's natural max length BUCKETED to a power
        of two (capped at max_len): the encoder jit compiles one variant
        per distinct width, and a per-batch exact width would recompile
        near-continuously on mixed-length ingest (remote compiles cost
        seconds on this backend and the cache does not populate)."""
        max_len = max_len or self.max_len

        def bucket(natural: int) -> int:
            w = 1
            while w < natural:
                w <<= 1
            return min(w, max_len)

        if self._native is not None and texts:
            ids, lens, fallback = self._native.encode_batch(texts, max_len)
            for i in fallback:
                r = self.encode(texts[i], max_len)
                ids[i, : len(r)] = r
                lens[i] = len(r)
            width = bucket(max(1, int(lens.max())))
            ids = ids[:, :width]
            mask = np.arange(width)[None, :] < lens[:, None]
            np.putmask(ids, ~mask, self.pad_id)
            return ids.astype(np.int32), mask
        rows = [self.encode(t, max_len) for t in texts]
        width = bucket(max(1, max((len(r) for r in rows), default=1)))
        ids = np.full((len(rows), width), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), width), dtype=bool)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = True
        return ids, mask
