"""Sharded IVF: per-shard partitions, one top-k merge.

Port of `rag_application_tpu/parallel/ivf.py`. Parity surface: the
reference's ANN recall knob is Qdrant HNSW hnsw_ef
(app/core/vector_store/qdrant/qdrant_handler.py:363-372) and its
"scale" story is adding service replicas; this is the ANN leg's
corpus-axis sharding (SURVEY §2.6 / §5.8).

Each shard holds its own coarse partition over its corpus rows and a
query reads only `probes` slabs a shard, so the read volume stays
probes x slab_bytes x n_shards whatever the corpus size. Candidate lists
(k ids + scores a shard) merge with one top-k on the mesh's first
device, the template of `sharded_fused_hybrid`.

Build is per shard on the host controller (each shard's k-means sees
only its rows — global centroids are unnecessary because every shard is
probed), through the port's `index.ivf.IVFIndex.build`; the stacked
arrays pad to the widest shard. The search keeps the single-device
engine's exactness rules (`index/ivf.py`): int8 slab dots exact in f32
pieces, every top-k `stable_topk`; the int8-stage scores are divided
by ``127`` or ``127^2`` in f32, as the reference's sharded program
divides (where its single-device engine multiplies by the reciprocal).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.dense import DenseIndex
from ..index.ivf import SLAB_TEMP_BYTES, IVFIndex, _f32_mm, _int8_mm
from ..ops.quant import quantize_int8
from ..ops.rrf import INVALID_ID
from ..ops.topk import NEG_INF, stable_topk
from .mesh import Mesh, as_shards
from .search import merge_shards


def build_sharded_ivf(dense: DenseIndex, n_shards: int, *,
                      rows_per_shard: Optional[int] = None,
                      **build_kw) -> dict:
    """Partition dense rows [0, size) into contiguous shards and build
    one IVFIndex per shard. Returns stacked numpy arrays (leading axis =
    shard, padded to the widest shard) ready for `place_sharded_ivf`."""
    n = dense.size
    if rows_per_shard is None:
        rows_per_shard = -(-n // n_shards)
    parts: List[Optional[IVFIndex]] = []
    for s in range(n_shards):
        lo = min(s * rows_per_shard, n)
        hi = min(lo + rows_per_shard, n)
        if hi <= lo:
            parts.append(None)
            continue
        shard_view = _ShardView(dense, lo, hi)
        parts.append(IVFIndex.build(shard_view, **build_kw))

    live = [p for p in parts if p is not None]
    c_max = max(p.centroids.shape[0] for p in live)
    nb_max = max(p.bucket_tbl.shape[0] for p in live)
    r = live[0].bucket_rows
    d = dense.cfg.dim

    cents = np.zeros((n_shards, c_max, d), np.float32)
    bcl = np.zeros((n_shards, nb_max), np.int32)
    btbl = np.zeros((n_shards, nb_max, r, d), np.int8)
    brid = np.full((n_shards, nb_max, r), -1, np.int32)
    nbs = np.zeros((n_shards,), np.int32)
    # capacity-mode per-row dequant factors (index/dense.py
    # int8_per_row_scale): raw int8 dots are NOT comparable across rows
    # without them — stacked bucket-aligned so the search multiplies in
    # place (the single-device engine does the same, index/ivf.py)
    scaled = getattr(dense, "int8_recip", None) is not None \
        and dense.vecs is None
    brecip = (np.zeros((n_shards, nb_max, r), np.float32)
              if scaled else None)
    recip_host = dense.int8_recip.cpu().numpy() if scaled else None
    for s, p in enumerate(parts):
        if p is None:
            continue
        c, nb = p.centroids.shape[0], p.bucket_tbl.shape[0]
        cents[s, :c] = p.centroids.cpu().numpy()
        bcl[s, :nb] = p.bucket_cluster.cpu().numpy()
        btbl[s, :nb] = p.bucket_tbl.cpu().numpy()
        nbs[s] = nb
        rid = p.bucket_rowids.cpu().numpy()
        # shard-local ids -> global rows
        grid = np.where(rid >= 0, rid + s * rows_per_shard, -1)
        brid[s, :nb] = grid
        if scaled:
            brecip[s, :nb] = np.where(
                grid >= 0, recip_host[np.clip(grid, 0, len(recip_host) - 1)],
                0.0)
    out = {"centroids": cents, "bucket_cluster": bcl,
           "bucket_tbl": btbl, "bucket_rowids": brid, "n_buckets": nbs,
           "rows_per_shard": rows_per_shard}
    if scaled:
        out["bucket_recip"] = brecip
    return out


class _ShardView:
    """A DenseIndex-shaped window over rows [lo, hi) (build-only)."""

    def __init__(self, dense: DenseIndex, lo: int, hi: int):
        self.cfg = dense.cfg
        self.device = dense.device
        self.size = hi - lo
        self.vecs = (dense.vecs[lo:hi] if dense.vecs is not None else None)
        self.int8 = dense.int8[lo:hi]
        self.int8_recip = (dense.int8_recip[lo:hi]
                           if getattr(dense, "int8_recip", None) is not None
                           else None)
        self.live = dense.live[lo:hi]


def place_sharded_ivf(mesh: Mesh, stacked: dict, *, axis: str = "data"):
    """Put the stacked build output shard-major on the mesh: each entry a
    list of per-shard tensors."""
    def put(name):
        return as_shards(mesh, stacked[name], axis=axis, stacked=True)

    return {
        "centroids": put("centroids"),
        "bucket_cluster": put("bucket_cluster"),
        "bucket_tbl": put("bucket_tbl"),
        "bucket_rowids": put("bucket_rowids"),
        "n_buckets": [int(x) for x in np.asarray(stacked["n_buckets"])],
        "bucket_recip": (put("bucket_recip")
                         if "bucket_recip" in stacked else None),
        "rows_per_shard": stacked["rows_per_shard"],
    }


def _local_search(cents, bcl, btbl, brid, nb, brcp, v_s, q, start: int,
                  k: int, probes: int, rescore_limit: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's probe, slab scan and (optional) exact rescore: its
    (vals, global ids), INVALID_ID where the score is not finite."""
    qn = q.shape[0]
    qf = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=1e-12)
    q8 = quantize_int8(qf)
    b_scores = _f32_mm(qf, cents.T)[:, bcl.long()]
    # padding buckets (beyond this shard's real count) are never probed
    pad_mask = torch.arange(b_scores.shape[-1], device=q.device) < nb
    b_scores = torch.where(pad_mask[None, :], b_scores, NEG_INF)
    p_eff = min(probes, b_scores.shape[-1])
    _, b_idx = stable_topk(b_scores, p_eff)

    # probe-chunked scoring: the gathered slab is held at f32 for the
    # product (index/ivf.py), so a chunk keeps it near SLAB_TEMP_BYTES
    d_ = q.shape[1]
    r = btbl.shape[1]
    chunk = max(1, min(p_eff, SLAB_TEMP_BYTES // max(1, qn * r * d_ * 4)))
    n_chunks = -(-p_eff // chunk)
    cpad = n_chunks * chunk - p_eff
    if cpad:
        b_idx = torch.nn.functional.pad(b_idx, (0, cpad))
    sc_parts, rid_parts = [], []
    for c0 in range(0, n_chunks * chunk, chunk):
        bc = b_idx[:, c0:c0 + chunk]
        slab = btbl[bc]                                   # (Q, c, R, d)
        s_ = _int8_mm(slab.reshape(qn, -1, d_), q8[:, :, None])[..., 0]
        s_ = s_.float()
        if brcp is not None:
            s_ = s_ * brcp[bc].reshape(qn, -1)
        sc_parts.append(s_)
        rid_parts.append(brid[bc].reshape(qn, -1))
    sc = torch.cat(sc_parts, dim=-1)
    rids = torch.cat(rid_parts, dim=-1)
    if cpad:
        probe_valid = torch.arange(n_chunks * chunk, device=q.device) < p_eff
        rids = torch.where(torch.repeat_interleave(probe_valid, r)[None, :],
                           rids, -1)
    sc = torch.where(rids >= 0, sc, NEG_INF)
    has_rescore = v_s is not None
    kk = min(rescore_limit if has_rescore else k, sc.shape[-1])
    top, pos = stable_topk(sc, kk)
    ids = torch.gather(rids, -1, pos)
    if has_rescore:
        local_ids = torch.clamp(ids - start, 0, v_s.shape[0] - 1).long()
        g = v_s[local_ids].float()                        # (Q, kk, d)
        exact = _f32_mm(g, qf[:, :, None])[..., 0]
        exact = torch.where(torch.isfinite(top), exact, NEG_INF)
        top, pos = stable_topk(exact, min(k, kk))
        ids = torch.gather(ids, -1, pos)
    else:
        # per-row scaled rows already carry their factor; only the query
        # quantization remains. A true f32 division, as the reference's
        # sharded program divides (a 0-d tensor divisor: CUDA turns a
        # division by a host scalar into a product with its reciprocal)
        c = 127.0 if brcp is not None else 127.0 * 127.0
        top = top / torch.full((), c, dtype=top.dtype, device=top.device)
        top, ids = top[:, :k], ids[:, :k]
    return top, torch.where(torch.isfinite(top), ids, INVALID_ID)


def sharded_ivf_search(
    mesh: Mesh,
    placed: dict,
    queries,                 # (Q, d) f32 replicated
    k: int,
    *,
    axis: str = "data",
    probes: int = 64,
    rescore_vecs=None,       # (N, d) bf16 row-sharded exact-rescore plane
    rescore_limit: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard probes its own partition; per-shard top-k lists merge
    on the mesh's first device. With `rescore_vecs` the shard
    exact-rescores its candidates before the merge (scores comparable
    across shards — cosines either way)."""
    rps = placed["rows_per_shard"]
    v_shards = (as_shards(mesh, rescore_vecs, axis=axis)
                if rescore_vecs is not None else None)
    recips = placed.get("bucket_recip")
    vals_l, idx_l = [], []
    for s, cents in enumerate(placed["centroids"]):
        q = torch.as_tensor(queries).to(cents.device).float()
        top, ids = _local_search(
            cents, placed["bucket_cluster"][s], placed["bucket_tbl"][s],
            placed["bucket_rowids"][s], placed["n_buckets"][s],
            recips[s] if recips is not None else None,
            v_shards[s] if v_shards is not None else None,
            q, s * rps, k, probes, rescore_limit)
        vals_l.append(top)
        idx_l.append(ids)
    kk = vals_l[0].shape[-1]
    out_v, out_i = merge_shards(mesh, vals_l, idx_l,
                                min(k, len(vals_l) * kk))
    return out_v, torch.where(torch.isfinite(out_v), out_i, INVALID_ID)
