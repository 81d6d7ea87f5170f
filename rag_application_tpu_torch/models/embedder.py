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

`encode_audio` and `encode_image` run the `MultimodalEncoder`'s audio
and image branches on the same device, with the reference's shape checks
and messages, in batches of ``batch_size`` whose tail is padded and cut;
with a text tower they raise ValueError, as the reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import EncoderConfig
from ..utils import DeviceLike
from .cache import EmbeddingCache
from .encoder import EncoderState, MultimodalEncoder, init_encoder
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

    # ------------------------------------------------------------- audio

    @property
    def supports_audio(self) -> bool:
        return isinstance(self.state.model, MultimodalEncoder)

    def encode_audio(self, features: np.ndarray,
                     texts: Optional[Sequence[str]] = None) -> np.ndarray:
        """Log-mel features (N, frames, mels) -> (N, out_dim) unit
        vectors via the multimodal tower's audio branch (parity:
        ImageBind ModalityType.AUDIO, imagebind_handler.py:23-32).
        Optional `texts` interleave caption tokens with the audio
        patches (single-tower fusion)."""
        if not self.supports_audio:
            raise ValueError(
                "audio embedding needs a MultimodalEncoder "
                "(init_encoder(multimodal=True))")
        model = self.state.model
        feats = np.asarray(features, dtype=np.float32)
        if feats.ndim == 2:
            feats = feats[None]
        if feats.shape[1:] != (model.audio_frames, model.audio_mels):
            raise ValueError(
                f"audio features must be (N, {model.audio_frames}, "
                f"{model.audio_mels}); got {feats.shape}")
        n = feats.shape[0]
        batch_texts = list(texts) if texts is not None else [""] * n
        if len(batch_texts) != n:
            raise ValueError(
                f"texts must match the feature batch: got {len(batch_texts)}"
                f" captions for {n} audio clips")
        return self._encode_media(batch_texts, texts is not None,
                                  audio=feats)

    # ------------------------------------------------------------- image

    @property
    def supports_images(self) -> bool:
        return self.supports_audio  # same single multimodal tower

    def encode_image(self, images: np.ndarray,
                     texts: Optional[Sequence[str]] = None) -> np.ndarray:
        """Raster images (N, S, S, 3) float in [0, 1] -> (N, out_dim)
        unit vectors via the multimodal tower's patch branch (parity:
        ImageBind ModalityType.VISION, imagebind_handler.py:23-32; the
        v2 interleaved text+image embedding, model_handler.py:131-169).
        Optional `texts` interleave caption tokens with the patches."""
        if not self.supports_images:
            raise ValueError(
                "image embedding needs a MultimodalEncoder "
                "(init_encoder(multimodal=True))")
        model = self.state.model
        imgs = np.asarray(images, dtype=np.float32)
        if imgs.ndim == 3:
            imgs = imgs[None]
        s = model.image_size
        if imgs.shape[1:] != (s, s, 3):
            raise ValueError(
                f"images must be (N, {s}, {s}, 3); got {imgs.shape}")
        n = imgs.shape[0]
        batch_texts = list(texts) if texts is not None else [""] * n
        if len(batch_texts) != n:
            raise ValueError(
                f"texts must match the image batch: got {len(batch_texts)}"
                f" captions for {n} images")
        return self._encode_media(batch_texts, texts is not None,
                                  images=imgs)

    def _encode_media(self, texts: List[str], captioned: bool, *,
                      images: Optional[np.ndarray] = None,
                      audio: Optional[np.ndarray] = None) -> np.ndarray:
        """One modality's (N, ...) inputs with their captions through the
        tower in batches of ``batch_size``, the tail padded with zero
        inputs and empty captions and cut."""
        media = images if images is not None else audio
        ids, mask = self.tokenizer.encode_batch(texts, self.max_len)
        if not captioned:
            mask = np.zeros_like(mask)  # media only: no text tokens attend
        n = media.shape[0]
        out = np.zeros((n, self.cfg.out_dim), dtype=np.float32)
        dev = self.device
        for start in range(0, n, self.batch_size):
            sl = slice(start, min(start + self.batch_size, n))
            k = sl.stop - sl.start
            pad = self.batch_size - k

            def up(a):
                a = np.pad(a[sl], ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                return torch.from_numpy(a).to(dev)

            b_media = up(media)
            vecs = self.state.model.apply(
                self.state.params, up(ids), up(mask),
                b_media if images is not None else None, None,
                b_media if audio is not None else None)
            out[sl] = vecs[:k].cpu().numpy()
        return out
