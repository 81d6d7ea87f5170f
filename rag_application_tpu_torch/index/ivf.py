"""IVF-flat ANN engine: coarse k-means partitions scanned as slabs.

Port of `rag_application_tpu/index/ivf.py`. The reference's device code
is XLA ops, not a Pallas kernel, so the port is plain PyTorch on the
index's device, with `matmul`/`bmm` for the large products:

  build:  spherical k-means (blocked assignment, one-hot-matmul centroid
          sums), every row assigned off the stored plane, rows reordered
          cluster-contiguous into fixed-size buckets of `bucket_rows`
          rows (padded with dead rows), the int8 slab table gathered.
  query:  one (Q, C) centroid product ranks clusters; each bucket
          inherits its cluster's score and the top `probes` buckets are
          scanned as (R, d) int8 slabs, in probe chunks; the top
          `rescore_limit` candidates (plus an exact-scanned tail of rows
          inserted since the build) are rescored against the bf16 rows.

What keeps the port's answers those of the reference:

  * Every top-k is `ops/topk.py::stable_topk` (ties toward the lower
    index, `lax.top_k`'s order). The bucket top-k is almost all ties by
    design: a cluster's buckets share its score.
  * The int8 dots are exact. CUDA has no int8 `bmm`, so the products run
    on int8 values held in f32 with TF32 off: at d <= 1024 every partial
    sum is an integer below 2^24 (127^2 * 1024 < 2^24), exact in any
    order. Wider rows are split into 1024-column pieces whose dots add in
    int32. Ids and int8-stage scores are then the reference's, bit for
    bit, on the card and on the CPU.
  * Candidates keep the reference's layout (probe-rank-major, padding
    probes masked to -1), so equal int dots meet the second top-k in the
    same positions.
  * The centroid, k-means and rescore products are full f32.

The index reads its `DenseIndex`'s planes afresh on every search: the
dense index writes them in place and a pin replaces them by copies
(`index/dense.py`), so no reference is kept from the build but the
gathered bucket table, which is a copy. `save`/`load` write and read the
reference's `.npz` layout: a file saved by either package loads in the
other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.quant import quantize_int8
from ..ops.rrf import INVALID_ID
from ..ops.topk import stable_topk
from ..utils import full_f32_matmul
from .dense import DenseIndex

# bytes of the gathered probe slab a chunk may hold at the product's
# width (f32), the reference's bound on its s32 temporary
SLAB_TEMP_BYTES = 1 << 31
# columns of one exact f32 piece of an int8 dot: 127^2 * 1024 < 2^24
INT8_DOT_COLS = 1024


@dataclass
class IVFSearchParams:
    probes: int = 128          # buckets scanned per query (the recall knob)
    rescore: bool = True       # exact bf16/int8 rescore of the candidates
    rescore_limit: int = 128   # candidates entering the exact rescore


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with full_f32_matmul():
        return a @ b


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``a @ b`` of int8 operands, contracting a's
    last axis (d) with b's second to last. Each <= INT8_DOT_COLS-wide
    piece of d runs in f32, where its integer sums are exact; the pieces
    add in int32."""
    out = None
    for c0 in range(0, a.shape[-1], INT8_DOT_COLS):
        part = _f32_mm(a[..., c0:c0 + INT8_DOT_COLS].float(),
                       b[..., c0:c0 + INT8_DOT_COLS, :].float())
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _kmeans(x: torch.Tensor, init: torch.Tensor, valid_n: int, *,
            n_clusters: int, iters: int, block_rows: int) -> torch.Tensor:
    """Spherical k-means: blocked assignment + one-hot-matmul updates.
    x: (N, d) f32 unit rows (N a multiple of block_rows); rows >= valid_n
    are padding and count for nothing (an unmasked zero row would tie to
    cluster 0). An empty cluster keeps its previous centroid. Returns
    (C, d) unit centroids."""
    n, d = x.shape
    cents = init
    rows = torch.arange(block_rows, device=x.device)
    for _ in range(iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32,
                           device=x.device)
        counts = torch.zeros((n_clusters,), dtype=torch.float32,
                             device=x.device)
        for b0 in range(0, n, block_rows):
            xb = x[b0:b0 + block_rows]
            assign = torch.argmax(_f32_mm(xb, cents.T), dim=-1)
            valid = ((b0 + rows) < valid_n).float()
            onehot = torch.zeros((block_rows, n_clusters),
                                 dtype=torch.float32, device=x.device)
            onehot.scatter_(1, assign[:, None], valid[:, None])
            sums = sums + _f32_mm(onehot.T, xb)
            counts = counts + onehot.sum(dim=0)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts[:, None], min=1.0), cents)
        cents = _normalize(new)
    return cents


def _assign(src: torch.Tensor, cents: torch.Tensor, *,
            block_rows: int) -> torch.Tensor:
    """Blocked nearest-centroid assignment straight off the stored plane
    (int8/bf16): each block converts and normalizes in f32, so the corpus
    is never held at f32."""
    out = []
    for b0 in range(0, src.shape[0], block_rows):
        xb = src[b0:b0 + block_rows].float()
        xb = xb * torch.rsqrt(torch.clamp((xb * xb).sum(dim=-1, keepdim=True),
                                          min=1e-12))
        out.append(torch.argmax(_f32_mm(xb, cents.T), dim=-1))
    return torch.cat(out).to(torch.int32)


def _gather_buckets(int8: torch.Tensor,
                    rowids: torch.Tensor) -> torch.Tensor:
    """(NB, R, d) int8 slab table: a gathered copy, dead slots zero."""
    safe = torch.where(rowids >= 0, rowids, 0).long()
    return torch.where((rowids >= 0)[..., None], int8[safe],
                       torch.zeros((), dtype=torch.int8, device=int8.device))


def _ivf_search(
    centroids: torch.Tensor,       # (C, d) f32 unit
    bucket_cluster: torch.Tensor,  # (NB,) int32
    bucket_tbl: torch.Tensor,      # (NB, R, d) int8
    bucket_rowids: torch.Tensor,   # (NB, R) int32, -1 = dead slot
    rescore_tbl: Optional[torch.Tensor],  # (cap, d) bf16 (or int8 cap mode)
    rescore_scale: float,
    row_recip: Optional[torch.Tensor],  # (cap,) per-row dequant
    tail_tbl: torch.Tensor,        # (T, d) int8 exact-scan tail (T may be 0)
    tail_rowids: torch.Tensor,     # (T,) int32
    queries: torch.Tensor,         # (Q, d) f32
    filter_mask: torch.Tensor,     # (cap,) bool
    k: int, probes: int, rescore_limit: int, has_rescore: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    q = _normalize(queries.float())
    q8 = quantize_int8(q)

    c_scores = _f32_mm(q, centroids.T)            # (Q, C)
    b_scores = c_scores[:, bucket_cluster.long()]  # (Q, NB)
    p_eff = min(probes, b_scores.shape[-1])
    _, b_idx = stable_topk(b_scores, p_eff)

    # probe-chunked scoring: the gathered (Q, c, R, d) slab is held at f32
    # for the product, so a chunk's probes keep it near SLAB_TEMP_BYTES
    qn, d_ = q.shape
    r = bucket_tbl.shape[1]
    chunk = max(1, min(p_eff, SLAB_TEMP_BYTES // max(1, qn * r * d_ * 4)))
    n_chunks = -(-p_eff // chunk)
    pad = n_chunks * chunk - p_eff
    if pad:
        # padding probes point at bucket 0 and are masked to rowid -1
        # after scoring, so they never rank
        b_idx = torch.nn.functional.pad(b_idx, (0, pad))
    sc_parts, rid_parts = [], []
    for c0 in range(0, n_chunks * chunk, chunk):
        bc = b_idx[:, c0:c0 + chunk]              # (Q, c)
        slab = bucket_tbl[bc]                     # (Q, c, R, d)
        sc_parts.append(_int8_mm(slab.reshape(qn, -1, d_),
                                 q8[:, :, None])[..., 0].float())
        rid_parts.append(bucket_rowids[bc].reshape(qn, -1))
    # probe-rank-major candidate order, as the reference's transpose gives
    scores = torch.cat(sc_parts, dim=-1)
    rids = torch.cat(rid_parts, dim=-1)
    if row_recip is not None:
        # per-row scaled int8 rows: restore the common cosine scale
        scores = scores * row_recip[torch.clamp(
            rids, 0, row_recip.shape[0] - 1).long()]
    if pad:
        probe_valid = torch.arange(n_chunks * chunk,
                                   device=rids.device) < p_eff
        probe_valid = torch.repeat_interleave(probe_valid, r)
        rids = torch.where(probe_valid[None, :], rids, -1)
    valid = rids >= 0
    valid &= filter_mask[torch.clamp(rids, 0,
                                     filter_mask.shape[0] - 1).long()]
    scores = torch.where(valid, scores, float("-inf"))

    # exact-scanned tail: rows inserted since the last build
    if tail_tbl.shape[0]:
        t_scores = _int8_mm(q8, tail_tbl.T).float()
        if row_recip is not None:
            t_scores = t_scores * row_recip[torch.clamp(
                tail_rowids, 0, row_recip.shape[0] - 1).long()][None, :]
        t_valid = tail_rowids >= 0
        t_valid &= filter_mask[torch.clamp(
            tail_rowids, 0, filter_mask.shape[0] - 1).long()]
        t_scores = torch.where(t_valid[None, :], t_scores, float("-inf"))
        scores = torch.cat([scores, t_scores], dim=-1)
        rids = torch.cat([rids, tail_rowids[None, :].expand(qn, -1)], dim=-1)

    kk = min(rescore_limit if has_rescore else k, scores.shape[-1])
    top, pos = stable_topk(scores, kk)
    ids = torch.gather(rids, -1, pos)

    if has_rescore:
        safe = torch.clamp(ids, 0, rescore_tbl.shape[0] - 1).long()
        g = rescore_tbl[safe].float()             # (Q, kk, d)
        exact = _f32_mm(g, q[:, :, None])[..., 0]
        exact = exact * (row_recip[safe] if row_recip is not None
                         else rescore_scale)
        exact = torch.where(torch.isfinite(top), exact, float("-inf"))
        top, pos = stable_topk(exact, min(k, kk))
        ids = torch.gather(ids, -1, pos)
    else:
        # int8 dot -> approximate cosine (the row factor is already
        # applied when per-row scaled; only the query's quantization
        # stays); XLA divides by a constant as a product with its f32
        # reciprocal, and so does this
        top = top * (1.0 / 127.0 if row_recip is not None
                     else 1.0 / (127.0 * 127.0))
        top, ids = top[:, :k], ids[:, :k]
    ids = torch.where(torch.isfinite(top), ids, INVALID_ID).to(torch.int32)
    return top, ids


class IVFIndex:
    """Coarse-quantizer partition index over a DenseIndex's rows."""

    def __init__(self, dense: DenseIndex, centroids, bucket_cluster,
                 bucket_tbl, bucket_rowids, *, built_n: int,
                 bucket_rows: int, rebuild_threshold: float = 0.25):
        self.dense = dense
        self.centroids = centroids
        self.bucket_cluster = bucket_cluster
        self.bucket_tbl = bucket_tbl
        self.bucket_rowids = bucket_rowids
        self.built_n = built_n        # rows covered by the partition
        self.bucket_rows = bucket_rows
        self.rebuild_threshold = rebuild_threshold

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, dense: DenseIndex, *, n_clusters: int = 1024,
              bucket_rows: int = 64, iters: int = 10,
              train_sample: int = 262_144, seed: int = 0,
              block_rows: int = 65_536) -> "IVFIndex":
        n = dense.size
        if n == 0:
            raise ValueError("empty index")
        d = dense.cfg.dim
        dev = dense.device
        n_clusters = int(min(n_clusters, max(1, n // max(bucket_rows, 8))))
        src = dense.vecs if dense.vecs is not None else dense.int8

        # training sample (full f32 rows, normalized), selected by the
        # reference's seeded generator
        rng = np.random.default_rng(seed)
        n_train = min(n, train_sample)
        sel = (np.arange(n) if n_train == n
               else rng.choice(n, size=n_train, replace=False))
        # pad the training set to a block multiple
        blk = min(block_rows, 1 << max(8, (n_train - 1).bit_length()))
        pad = (-n_train) % blk
        train = _normalize(src[torch.from_numpy(sel).to(dev)].float())
        if pad:
            train = torch.cat([train, torch.zeros((pad, d),
                                                  dtype=torch.float32,
                                                  device=dev)])
        init = train[torch.from_numpy(
            rng.choice(n_train, size=n_clusters, replace=False)).to(dev)]
        cents = _kmeans(train, init, n_train, n_clusters=n_clusters,
                        iters=iters, block_rows=blk)
        del train

        # full assignment (blocked, off the stored plane); assignments
        # past n (the capacity's padding) are dropped
        a_blk = blk
        while src.shape[0] % a_blk:
            a_blk //= 2
        assign = _assign(src, cents,
                         block_rows=max(a_blk, 1)).cpu().numpy()[:n]

        # host-side reorder into fixed-size buckets, cluster-contiguous
        order = np.argsort(assign, kind="stable")
        counts = np.bincount(assign, minlength=n_clusters)
        buckets_per_cluster = np.maximum(1, -(-counts // bucket_rows))
        n_buckets = int(buckets_per_cluster.sum())
        bucket_cluster = np.repeat(np.arange(n_clusters, dtype=np.int32),
                                   buckets_per_cluster)
        rowids = np.full((n_buckets, bucket_rows), -1, dtype=np.int32)
        b0 = np.concatenate([[0], np.cumsum(buckets_per_cluster)])[:-1]
        pos = 0
        for c in range(n_clusters):
            rows_c = order[pos:pos + counts[c]]
            pos += counts[c]
            flat = rowids[b0[c]:b0[c] + buckets_per_cluster[c]].reshape(-1)
            flat[:counts[c]] = rows_c
            rowids[b0[c]:b0[c] + buckets_per_cluster[c]] = flat.reshape(
                -1, bucket_rows)

        # the slab table, gathered on the device
        rowids_dev = torch.from_numpy(rowids).to(dev)
        out = cls(dense, cents, torch.from_numpy(bucket_cluster).to(dev),
                  _gather_buckets(dense.int8, rowids_dev), rowids_dev,
                  built_n=n, bucket_rows=bucket_rows)
        # remembered so rebuild() reproduces this configuration
        out._build_kw = dict(n_clusters=n_clusters, bucket_rows=bucket_rows,
                             iters=iters, train_sample=train_sample,
                             seed=seed, block_rows=block_rows)
        return out

    # ------------------------------------------------------------ queries

    @property
    def tail_rows(self) -> int:
        return self.dense.size - self.built_n

    @property
    def needs_rebuild(self) -> bool:
        return self.tail_rows > self.rebuild_threshold * max(self.built_n, 1)

    def search(self, queries, k: int = 10, *,
               params: Optional[IVFSearchParams] = None,
               filter_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores (Q, k) f32, row ids (Q, k) int32), best first; empty
        slots score -inf with id INVALID_ID. ``filter_mask``: (capacity,)
        bool, numpy or tensor."""
        p = params or IVFSearchParams()
        d = self.dense
        dev = d.device
        rescore_tbl = d.vecs if d.vecs is not None else d.int8
        rescore_scale = 1.0 if d.vecs is not None else 1.0 / 127.0
        tail_n = self.tail_rows
        # the tail is padded to a power-of-two bucket, as the reference's
        t_pad = max(256, 1 << (max(1, tail_n) - 1).bit_length()) \
            if tail_n else 0
        if tail_n:
            tail_tbl = d.int8[self.built_n:self.built_n + min(
                t_pad, d.int8.shape[0] - self.built_n)]
            tcur = tail_tbl.shape[0]
            if tcur < t_pad:
                tail_tbl = torch.nn.functional.pad(
                    tail_tbl, (0, 0, 0, t_pad - tcur))
            tail_ids = self.built_n + np.arange(t_pad, dtype=np.int32)
            tail_ids = torch.from_numpy(
                np.where(tail_ids < d.size, tail_ids, -1)).to(dev)
        else:
            tail_tbl = torch.zeros((0, d.cfg.dim), dtype=torch.int8,
                                   device=dev)
            tail_ids = torch.zeros((0,), dtype=torch.int32, device=dev)
        fm = d.live if filter_mask is None else d.live & torch.as_tensor(
            filter_mask, device=dev)
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.asarray(queries, dtype=np.float32))
        return _ivf_search(
            self.centroids, self.bucket_cluster, self.bucket_tbl,
            self.bucket_rowids, rescore_tbl if p.rescore else None,
            rescore_scale, d.int8_recip if d.vecs is None else None,
            tail_tbl, tail_ids, queries.to(dev, torch.float32), fm,
            k=k, probes=p.probes, rescore_limit=p.rescore_limit,
            has_rescore=p.rescore)

    def insert_batch(self, rows: np.ndarray) -> None:
        """Rows already inserted into the DenseIndex join the exact-scan
        tail automatically (search covers [built_n, size)); call
        `rebuild()` when `needs_rebuild` to fold them into the
        partition."""
        del rows

    def rebuild(self, **kw) -> "IVFIndex":
        """Fold the tail into a fresh partition. Reuses the original
        build configuration (n_clusters/iters/...) unless overridden,
        and keeps this index's rebuild_threshold."""
        params = dict(getattr(self, "_build_kw", {}))
        params.update(kw)
        threshold = self.rebuild_threshold
        fresh = IVFIndex.build(self.dense, **params)
        self.__dict__.update(fresh.__dict__)
        self.rebuild_threshold = threshold
        return self

    # -------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """Centroids + partition layout to an npz, in the reference's
        layout (the dense shard checkpoints separately through
        index/checkpoint.py; the slab table is not stored: it regathers
        from the int8 plane on load)."""
        np.savez(path,
                 centroids=self.centroids.cpu().numpy(),
                 bucket_cluster=self.bucket_cluster.cpu().numpy(),
                 bucket_rowids=self.bucket_rowids.cpu().numpy(),
                 built_n=self.built_n, bucket_rows=self.bucket_rows,
                 rebuild_threshold=self.rebuild_threshold,
                 build_kw=json.dumps(getattr(self, "_build_kw", {})))

    @classmethod
    def load(cls, path: str, dense: DenseIndex) -> "IVFIndex":
        d = np.load(path)
        dev = dense.device
        rowids = torch.from_numpy(d["bucket_rowids"]).to(dev)
        out = cls(dense, torch.from_numpy(d["centroids"]).to(dev),
                  torch.from_numpy(d["bucket_cluster"]).to(dev),
                  _gather_buckets(dense.int8, rowids), rowids,
                  built_n=int(d["built_n"]),
                  bucket_rows=int(d["bucket_rows"]),
                  rebuild_threshold=float(d["rebuild_threshold"]))
        # the build configuration, so rebuild() after a restart
        # reproduces it
        if "build_kw" in d.files:
            kw = json.loads(str(d["build_kw"]))
            if kw:
                out._build_kw = kw
        return out
