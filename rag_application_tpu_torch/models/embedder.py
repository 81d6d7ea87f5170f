"""Batched embedding pipeline: cache -> tokenize -> device forward.

Port of `rag_application_tpu/models/embedder.py`. All cache misses of a
call are packed into fixed-size device batches, the tail padded to the
full batch size (padded rows carry no valid token and pool to zero), and
the forward runs on the encoder's device.

One difference from the reference, on purpose: the reference guards the
cache with ``if self.cache``, and an empty `EmbeddingCache` is falsy
(it defines ``__len__``), so the reference never reads or fills its
cache. The port tests ``is not None``, so repeated texts skip the
device. Vectors are the same either way.

The multimodal branches (`encode_audio`, `encode_image`) need the
`MultimodalEncoder`, which is not ported yet: they raise, and
`supports_audio`/`supports_images` are False.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import EncoderConfig
from ..utils import DeviceLike
from .cache import EmbeddingCache
from .encoder import EncoderState, init_encoder
from .tokenizer import HashTokenizer


class Embedder:
    def __init__(
        self,
        state: Optional[EncoderState] = None,
        *,
        cfg: Optional[EncoderConfig] = None,
        tokenizer: Optional[HashTokenizer] = None,
        cache: Optional[EmbeddingCache] = None,
        batch_size: int = 64,
        max_len: int = 128,
        device: DeviceLike = None,
    ):
        self.cfg = cfg or (state.cfg if state else EncoderConfig())
        self.state = state or init_encoder(self.cfg, max_len=max_len,
                                           device=device)
        self.device = next(self.state.model.parameters()).device
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size,
                                                    max_len)
        self.cache = cache if cache is not None else EmbeddingCache(
            self.cfg.cache_capacity
        )
        self.batch_size = batch_size
        self.max_len = max_len

    @property
    def dim(self) -> int:
        return self.cfg.out_dim

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        dev = self.device
        out = self.state.model.apply(self.state.params,
                                     torch.from_numpy(ids).to(dev),
                                     torch.from_numpy(mask).to(dev))
        return out.cpu().numpy()

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Texts -> (N, out_dim) f32 unit vectors, cache-aware and batched."""
        n = len(texts)
        out = np.zeros((n, self.cfg.out_dim), dtype=np.float32)
        miss_idx: List[int] = []
        for i, t in enumerate(texts):
            hit = self.cache.get(t) if self.cache is not None else None
            if hit is not None:
                out[i] = hit
            else:
                miss_idx.append(i)

        for start in range(0, len(miss_idx), self.batch_size):
            chunk = miss_idx[start : start + self.batch_size]
            batch_texts = [texts[i] for i in chunk]
            ids, mask = self.tokenizer.encode_batch(batch_texts, self.max_len)
            # Pad the tail batch to the full batch size: one shape.
            pad = self.batch_size - len(chunk)
            if pad:
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            vecs = self._forward(ids, mask)[: len(chunk)]
            for j, i in enumerate(chunk):
                out[i] = vecs[j]
                if self.cache is not None:
                    self.cache.put(texts[i], vecs[j])
        return out

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]

    # ------------------------------------------------- audio and image

    @property
    def supports_audio(self) -> bool:
        return False  # the MultimodalEncoder is not ported yet

    @property
    def supports_images(self) -> bool:
        return self.supports_audio  # same single multimodal tower

    def encode_audio(self, features: np.ndarray,
                     texts: Optional[Sequence[str]] = None) -> np.ndarray:
        raise NotImplementedError(
            "encode_audio needs the MultimodalEncoder, not ported yet")

    def encode_image(self, images: np.ndarray,
                     texts: Optional[Sequence[str]] = None) -> np.ndarray:
        raise NotImplementedError(
            "encode_image needs the MultimodalEncoder, not ported yet")
