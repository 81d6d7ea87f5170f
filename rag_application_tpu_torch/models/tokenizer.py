"""Deterministic hash tokenizer.

Copy of `rag_application_tpu/models/tokenizer.py` (numpy and the
standard library only).

The reference never tokenizes locally — embeddings come from HTTP model
services (app/core/models/model_handler.py, AgentAPI/app/embed/embed.py).
The TPU framework runs the encoder on device, so it needs a tokenizer
that works offline with zero downloaded assets: lowercase word tokens
mapped into a fixed id space by a stable hash (feature hashing). A
HF `transformers` tokenizer can be dropped in instead when vocab files
are available (the `encode_batch` contract is the same).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
N_SPECIAL = 4


def _stable_hash(token: str) -> int:
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:8], "little")


class HashTokenizer:
    def __init__(self, vocab_size: int = 30528, max_len: int = 512):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def token_ids(self, text: str) -> List[int]:
        toks = _TOKEN_RE.findall(text.lower())
        space = self.vocab_size - N_SPECIAL
        return [N_SPECIAL + _stable_hash(t) % space for t in toks]

    def encode_batch(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Texts -> (ids (B, L) int32, mask (B, L) bool) with [CLS] ... [SEP]."""
        max_len = max_len or self.max_len
        ids = np.full((len(texts), max_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=bool)
        for i, text in enumerate(texts):
            body = self.token_ids(text)[: max_len - 2]
            seq = [CLS_ID] + body + [SEP_ID]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = True
        return ids, mask
