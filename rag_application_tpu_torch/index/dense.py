"""Device-resident dense vector index shard.

Port of `rag_application_tpu/index/dense.py`. Storage:

  * ``vecs``      (cap, d)  bf16 L2-normalized rows (absent in capacity mode).
  * ``int8``      (cap, d)  int8 quantization of the rows (absent in
                  bf16-only mode); in capacity mode rows quantize at
                  127/max|x| with ``int8_recip`` (cap,) f32 holding the
                  per-row dequantization factor.
  * ``inv_norms`` (cap, M)  f32 inverse prefix norms of the matryoshka views.
  * ``live``      (cap,) bool tombstone mask.
  * ``prefix_int8`` (cap, p) optional int8 of the renormalized prefix.

Capacity grows by doubling. Unlike the reference's donated jit updates,
inserts write the capacity tensors in place; growth allocates the doubled
tensors and copies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import IndexConfig
from ..ops.quant import prepare_vectors_into, quantize_int8
from ..ops.topk import blocked_topk, gather_rescore
from ..utils import DeviceLike, resolve_device


def _int8_scaled(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-mode per-row max-abs int8 scaling: the row quantizes at
    s_r = 127/max|x_r| and the factor 1/s_r is returned beside it."""
    xn = xf * torch.rsqrt(
        torch.clamp((xf * xf).sum(dim=-1, keepdim=True), min=1e-24))
    amax = torch.clamp(xn.abs().amax(dim=-1, keepdim=True), min=1e-12)
    i8 = torch.clamp(torch.round(xn * (127.0 / amax)), -127, 127)
    return i8.to(torch.int8), (amax[:, 0] / 127.0).float()


def _prefix_int8(xf: torch.Tensor, prefix_dim: int) -> torch.Tensor:
    """int8 of the renormalized first `prefix_dim` columns (the raw int8
    dot is then the prefix cosine)."""
    xp = xf[:, :prefix_dim]
    xp = xp * torch.rsqrt(
        torch.clamp((xp * xp).sum(dim=-1, keepdim=True), min=1e-12))
    return torch.clamp(torch.round(xp * 127.0), -127, 127).to(torch.int8)


class DenseIndex:
    def __init__(self, config: Optional[IndexConfig] = None, *,
                 device: DeviceLike = None):
        self.cfg = config or IndexConfig()
        self.device = resolve_device(device)
        cap = self.cfg.initial_capacity
        d = self.cfg.dim
        m = len(self.cfg.matryoshka_dims)
        if not self.cfg.store_bf16 and not self.cfg.store_int8:
            raise ValueError("at least one of store_bf16/store_int8 required")
        dev = self.device
        self.vecs = (torch.zeros((cap, d), dtype=torch.bfloat16, device=dev)
                     if self.cfg.store_bf16 else None)
        self.int8 = (torch.zeros((cap, d), dtype=torch.int8, device=dev)
                     if self.cfg.store_int8 else None)
        self.inv_norms = torch.zeros((cap, m), dtype=torch.float32,
                                     device=dev)
        self.int8_recip = (
            torch.zeros((cap,), dtype=torch.float32, device=dev)
            if (self.cfg.store_int8 and not self.cfg.store_bf16
                and self.cfg.int8_per_row_scale) else None)
        self.live = torch.zeros((cap,), dtype=torch.bool, device=dev)
        p = self.cfg.scan_prefix_dim
        if p and (p % 128 != 0 or p >= d):
            raise ValueError(
                f"scan_prefix_dim must be a multiple of 128 below dim, got {p}")
        self.prefix_int8 = (torch.zeros((cap, p), dtype=torch.int8,
                                        device=dev) if p else None)
        self.size = 0  # rows [0, size) are allocated (live unless deleted)
        # False until the first delete(): lets the fused scan drop the
        # live mask entirely when size == capacity
        self.has_deletes = False

    @property
    def capacity(self) -> int:
        plane = self.vecs if self.vecs is not None else self.int8
        return plane.shape[0]

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _grow(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        pad = new_cap - self.capacity

        def grown(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if t is None:
                return None
            out = torch.zeros((t.shape[0] + pad,) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            out[:t.shape[0]] = t
            return out

        self.vecs = grown(self.vecs)
        self.int8 = grown(self.int8)
        self.inv_norms = grown(self.inv_norms)
        self.int8_recip = grown(self.int8_recip)
        self.live = grown(self.live)
        self.prefix_int8 = grown(self.prefix_int8)

    def insert(self, embeddings) -> np.ndarray:
        """Normalize + derive views + append a batch. Returns row ids.
        Half-width inputs (f16/bf16) are upcast on the device."""
        xf = torch.as_tensor(embeddings, device=self.device).float()
        n = xf.shape[0]
        if self.size + n > self.capacity:
            self._grow(self.size + n)
        start, end = self.size, self.size + n
        # one prep pass (one CUDA launch on the card) writes rows
        # [start, end) of the planes in place and sets them live, in
        # every storage mode; capacity mode's int8 is scaled per row
        # below, as the reference
        scaled = self.int8_recip is not None
        prepare_vectors_into(xf, self.cfg.matryoshka_dims, self.vecs,
                             None if scaled else self.int8, self.inv_norms,
                             self.live, start)
        if scaled:
            i8, recip = _int8_scaled(xf)
            self.int8_recip[start:end] = recip
            self.int8[start:end] = i8
        if self.prefix_int8 is not None:
            self.prefix_int8[start:end] = _prefix_int8(
                xf, self.cfg.scan_prefix_dim)
        self.size = end
        return np.arange(start, end)

    def delete(self, rows) -> None:
        """Tombstone rows."""
        rows = torch.as_tensor(np.asarray(rows), device=self.device).long()
        self.live[rows] = False
        self.has_deletes = True

    @property
    def fully_live(self) -> bool:
        """True when the live mask is provably all-ones over the whole
        capacity (every slot allocated, nothing ever deleted)."""
        return self.size == self.capacity and not self.has_deletes

    # ---------------------------------------------------------------- query

    def _mask(self, filter_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if filter_mask is None:
            return self.live
        return self.live & torch.as_tensor(filter_mask, device=self.device)

    def normalize_queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries, device=self.device).float()
        return q / torch.clamp(torch.linalg.vector_norm(
            q, dim=-1, keepdim=True), min=1e-12)

    def search(self, queries, k: int, *, filter_mask=None,
               approx: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-precision search; in capacity mode the int8 table is
        scanned and scores are rescaled back to cosines."""
        if self.vecs is None:
            vals, ids = self.search_int8(queries, k, filter_mask=filter_mask,
                                         approx=approx)
            scale = (1.0 / 127.0 if self.int8_recip is not None
                     else 1.0 / (127.0 * 127.0))
            return vals * scale, ids
        q = self.normalize_queries(queries).to(self.vecs.dtype)
        return blocked_topk(
            self.vecs, q, k, block_size=self.cfg.block_size,
            valid_n=self.size, filter_mask=self._mask(filter_mask),
            approx=approx, recall_target=self.cfg.approx_recall_target)

    def search_int8(self, queries, k: int, *, filter_mask=None,
                    approx: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantized candidate generation."""
        if self.int8 is None:
            raise ValueError("store_int8=False: no quantized table")
        q8 = quantize_int8(self.normalize_queries(queries))
        return blocked_topk(
            self.int8, q8, k, block_size=self.cfg.block_size,
            valid_n=self.size, inv_norms=self.int8_recip,
            filter_mask=self._mask(filter_mask), approx=approx,
            recall_target=self.cfg.approx_recall_target)

    def search_matryoshka(self, queries, k: int, level: int, *,
                          filter_mask=None, approx: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefix-view candidate generation at matryoshka level ``level``."""
        if self.vecs is None:
            raise ValueError(
                "store_bf16=False: matryoshka prefix views need the bf16 "
                "plane (the int8 table is full-dim only)")
        dim = self.cfg.matryoshka_dims[level]
        q = self.normalize_queries(queries).to(self.vecs.dtype)
        return blocked_topk(
            self.vecs, q, k, block_size=self.cfg.block_size,
            valid_n=self.size, prefix_dim=dim,
            inv_norms=self.inv_norms[:, level].contiguous(),
            filter_mask=self._mask(filter_mask), approx=approx,
            recall_target=self.cfg.approx_recall_target)

    def rescore(self, queries, candidates, candidate_valid=None, *,
                level: Optional[int] = None) -> torch.Tensor:
        """Exact rescore of candidate rows; with ``level`` set, in the
        matryoshka prefix view at that level."""
        q = self.normalize_queries(queries)
        candidates = torch.as_tensor(candidates, device=self.device)
        safe = torch.clamp(candidates, 0, self.capacity - 1)
        table = self.vecs if self.vecs is not None else self.int8
        if level is None:
            scores = gather_rescore(table, q, safe,
                                    candidate_valid=candidate_valid)
            scores = scores * self._rescore_scale(safe)
        else:
            dim = self.cfg.matryoshka_dims[level]
            scores = gather_rescore(table[:, :dim], q[:, :dim], safe,
                                    candidate_valid=candidate_valid)
            scores = scores * self._rescore_scale(safe)
            scores = scores * self.inv_norms[safe.long(), level]
        in_range = (candidates >= 0) & (candidates < self.size)
        return torch.where(in_range, scores, float("-inf"))

    def _rescore_scale(self, safe_rows):
        """Per-candidate dequantization factor for the rescore table."""
        if self.vecs is not None:
            return 1.0
        if self.int8_recip is not None:
            return self.int8_recip[safe_rows.long()]
        return 1.0 / 127.0
