"""Sharded BM25 device views: one local inverted index per corpus shard.

Copy of `rag_application_tpu/parallel/sparse.py` (host numpy), over the
port's `index.sparse.SparseIndex`. Corpus rows split contiguously over
the mesh axis; each shard holds a term-major postings table and
doc-major rescore view over ITS rows only, with **global** BM25
statistics (idf over the whole corpus, global avgdl) so per-shard
scores are directly comparable in the cross-shard merge — sharding
changes the layout, never a score.

Host-side build mirrors `SparseIndex.rebuild()` (vectorized, no per-doc
loops); the outputs stack per-shard arrays on a leading axis, which
`parallel.mesh.shard_stacked` places one slice a shard.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..index.sparse import SparseIndex
from ..utils import round_up


def build_sharded_sparse(sparse: SparseIndex, n_shards: int) -> Dict:
    """Per-shard postings + doc views with global statistics.

    Rows are split contiguously: shard s owns rows
    [s*rows_per_shard, (s+1)*rows_per_shard). Returns a dict of stacked
    numpy arrays (leading axis = shard):
      post_packed (S, V_pad, P) int32 — packed local postings
        ((impact<<21) | LOCAL doc id; padding = rows_per_shard sentinel)
      doc_packed  (S, rows_per_shard+1, 2L) int32 — local rescore view
      plus meta: rows_per_shard, v_pad, p, l.
    """
    cfg = sparse.cfg
    n = len(sparse)
    if n == 0:
        raise ValueError("empty sparse index")
    rows_per_shard = -(-n // n_shards)  # ceil: last shard padded
    if rows_per_shard + 1 > 1 << 21:
        # local doc ids share an int32 with the 10-bit impact; beyond
        # 2^21-1 rows/shard they would silently corrupt both fields
        # (SparseIndex.rebuild falls back to a two-array layout at this
        # size; the sharded path asks for more shards instead)
        raise ValueError(
            f"{rows_per_shard} rows/shard exceeds the packed-postings "
            f"limit (2^21-1); shard over more devices")
    rows, terms, tfs, idf, avgdl, live = sparse._stats()
    w = (sparse._weights(rows, tfs, idf[terms], avgdl)
         if rows.size else rows.astype(np.float64))
    v = len(sparse.analyzer)
    v_pad = max(256, 1 << math.ceil(math.log2(v + 1))) if v else 256
    wmax = float(w.max()) if w.size else 1.0

    shard_of = rows // rows_per_shard
    local = rows - shard_of * rows_per_shard

    # postings width: max per (shard, term) run length
    if rows.size:
        key = shard_of * v_pad + terms
        order = np.lexsort((-w, key))
        k_sorted = key[order]
        run_start = np.searchsorted(k_sorted, np.unique(k_sorted), side="left")
        run_end = np.searchsorted(k_sorted, np.unique(k_sorted), side="right")
        max_plen = int((run_end - run_start).max())
    else:
        max_plen = 1
    p = max(128, min(cfg.max_postings_per_term, round_up(max_plen, 128)))

    post = np.full((n_shards, v_pad, p), rows_per_shard, dtype=np.int32)
    if rows.size:
        ls, ts, ws, lo = (shard_of[order], terms[order], w[order], local[order])
        starts = np.searchsorted(k_sorted, k_sorted, side="left")
        rank = np.arange(k_sorted.size) - starts
        keep = rank < p
        # 1019 cap: keep packed ints out of the f32 Inf/NaN bit range
        # (see index/sparse.py)
        wq = np.clip(np.ceil(ws[keep] / max(wmax, 1e-12) * 1019.0),
                     1, 1019).astype(np.int64)
        post[ls[keep], ts[keep], rank[keep]] = (
            (wq << 21) | lo[keep]).astype(np.int32)

    # doc-major local views
    if rows.size:
        order2 = np.lexsort((-w, rows))
        r2, t2, w2 = rows[order2], terms[order2], w[order2]
        row_start = np.searchsorted(r2, np.arange(n), side="left")
        rank2 = np.arange(r2.size) - row_start[r2]
        max_dlen = int(np.bincount(r2, minlength=1).max())
    else:
        r2 = t2 = rank2 = np.zeros(0, dtype=np.int64)
        w2 = np.zeros(0, dtype=np.float64)
        max_dlen = 1
    l = max(32, min(cfg.max_terms_per_doc, round_up(max_dlen, 32)))
    doc_terms = np.full((n_shards, rows_per_shard + 1, l), -1, dtype=np.int32)
    doc_w = np.zeros((n_shards, rows_per_shard + 1, l), dtype=np.float32)
    keep2 = rank2 < l
    s2 = r2[keep2] // rows_per_shard
    lo2 = r2[keep2] - s2 * rows_per_shard
    doc_terms[s2, lo2, rank2[keep2]] = t2[keep2]
    doc_w[s2, lo2, rank2[keep2]] = w2[keep2]
    doc_packed = np.concatenate(
        [doc_terms, doc_w.view(np.int32)], axis=-1)

    return {
        "post_packed": post,
        "doc_packed": doc_packed,
        "rows_per_shard": rows_per_shard,
        "v_pad": v_pad,
        "p": p,
        "l": l,
    }
