"""Sharded search: corpus rows over the mesh, one top-k merge.

Port of `rag_application_tpu/parallel/search.py`. A corpus larger than
one device's memory shards its rows across devices; every shard scans
its rows with the same blocked top-k; the per-shard candidate lists are
copied to the mesh's first device and one top-k merges them. Candidate
lists are tiny (k ids + scores a query a shard), so the merge moves KBs,
not the corpus.

Where the reference runs a `shard_map` body once per device, the port
runs the same body for each shard in turn, from the calling thread, on
the shard's tensors and device (`parallel/mesh.py`), with no host sync
between shards; the caller's first read of the merged result is the one
sync. The merge concatenates the shards' (Q, k) lists shard-major, as
`all_gather` + transpose does, and takes `ops.topk.stable_topk`, which
is `lax.top_k`'s tie order. A sharded argument is a list of per-shard
tensors (`shard_corpus`, `parallel.mesh.shard_rows` /
`shard_stacked`), or a whole array, which is placed first.

Each shard of `sharded_fused_hybrid` runs the port's
`search.fused.fused_core` with the spec the reference builds: the plain
blocked scan (`scan_impl="xla"`, `ops.topk.blocked_topk`), no prefix
scan, dense final ranking, and the sparse branch through
`ops.bm25.bm25_topk`, whose stage 2 launches `csrc/bm25_match.cu` once
per shard on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quant import quantize_int8
from ..ops.rrf import INVALID_ID
from ..ops.topk import NEG_INF, blocked_topk, gather_rescore, stable_topk
from .mesh import Mesh, as_shards, shard_rows


def _rows_per_shard(shards: Sequence[torch.Tensor]) -> int:
    rps = shards[0].shape[0]
    if any(s.shape[0] != rps for s in shards):
        raise ValueError(f"unequal shards {[s.shape[0] for s in shards]}")
    return rps


def _replicated(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def merge_shards(mesh: Mesh, vals: List[torch.Tensor],
                 ids: List[torch.Tensor], k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard's (Q, kk) list on the mesh's first device, shard-major
    along the last axis, then the top ``k`` (the reference's all_gather,
    transpose and ``lax.top_k``)."""
    dev = mesh.first
    all_v = torch.cat([v.to(dev) for v in vals], dim=-1)
    all_i = torch.cat([i.to(dev) for i in ids], dim=-1)
    top, pos = stable_topk(all_v, k)
    return top, torch.gather(all_i, -1, pos)


def sharded_topk(
    mesh: Mesh,
    corpus,
    queries,
    k: int,
    *,
    axis: str = "data",
    valid_n: Optional[int] = None,
    block_size: int = 131072,
    approx: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded corpus.

    Args:
      corpus: (N, d) with N divisible by mesh.shape[axis], or its shards
        (`shard_corpus`).
      queries: (Q, d), replicated.
      valid_n: logical corpus size (global row count).

    Returns (vals (Q, k), idx (Q, k)) on the mesh's first device, with
    global row indices.
    """
    shards = as_shards(mesh, corpus, axis=axis)
    rps = _rows_per_shard(shards)
    if valid_n is None:
        valid_n = rps * len(shards)
    vals_l, idx_l = [], []
    for s, shard in enumerate(shards):
        start = s * rps
        # rows beyond the logical size are padding on the last shard
        local_valid = min(max(valid_n - start, 0), rps)
        vals, idx = blocked_topk(
            shard, _replicated(queries, shard.device), k,
            block_size=min(block_size, rps), approx=approx)
        vals = torch.where(idx < local_valid, vals, NEG_INF)
        vals_l.append(vals)
        idx_l.append(idx + start)
    return merge_shards(mesh, vals_l, idx_l, k)


def shard_corpus(mesh: Mesh, corpus, *, axis: str = "data"
                 ) -> List[torch.Tensor]:
    """Pad rows to a shard multiple and put one slab on each device of
    ``axis``."""
    corpus = torch.as_tensor(np.asarray(corpus)) \
        if not isinstance(corpus, torch.Tensor) else corpus
    n_shards = mesh.shape[axis]
    pad = (-corpus.shape[0]) % n_shards
    if pad:
        corpus = torch.nn.functional.pad(corpus, (0, 0, 0, pad))
    return shard_rows(mesh, corpus, axis=axis)


def sharded_hybrid_topk(
    mesh: Mesh,
    vecs,       # (N, d) bf16/f32 row-sharded over `axis`
    int8,       # (N, d) int8 row-sharded
    queries,    # (Q, d) f32 replicated, unit-norm
    k: int,
    *,
    axis: str = "data",
    candidates: int = 64,
    block_size: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded dense funnel: per-shard int8 scan -> per-shard exact
    rescore of local candidates -> merge of (k candidates a shard) ->
    global top-k. Only candidate lists move; the corpus never does."""
    v_shards = as_shards(mesh, vecs, axis=axis)
    i_shards = as_shards(mesh, int8, axis=axis)
    rps = _rows_per_shard(v_shards)
    vals_l, idx_l = [], []
    for s, (v_s, i8_s) in enumerate(zip(v_shards, i_shards)):
        start = s * rps
        q = _replicated(queries, v_s.device)
        _, cand = blocked_topk(i8_s, quantize_int8(q), candidates,
                               block_size=min(block_size, rps), approx=True)
        # exact local rescore at full precision
        exact = gather_rescore(v_s, q, torch.clamp(cand, 0, rps - 1))
        top, pos = stable_topk(exact, min(k, candidates))
        vals_l.append(top)
        idx_l.append(torch.gather(cand, -1, pos) + start)
    return merge_shards(mesh, vals_l, idx_l, k)


def sharded_fused_hybrid(
    mesh: Mesh,
    vecs,             # (S*R, d) bf16/f32 row-sharded over `axis`, or None
                      # (capacity mode: int8-only shards, rescore
                      # dequantizes)
    int8,             # (S*R, d) int8 row-sharded
    inv_norms,        # (S*R, M) f32 row-sharded (matryoshka prefix
                      # norms; None disables the cascade)
    live,             # (S*R,) bool row-sharded
    post_packed,      # (S, V_pad, P) int32 stacked postings, or None
    doc_packed,       # (S, R+1, 2L) int32 stacked doc views, or None
    queries,          # (Q, d) f32 replicated
    q_rows,           # (Q, T) int32 replicated
    q_terms,          # (Q, T) int32 replicated
    q_valid,          # (Q, T) bool replicated
    k: int,
    *,
    axis: str = "data",
    spec=None,
    valid_n: Optional[int] = None,     # global logical row count
    filter_mask=None,                  # (S*R,) bool row-sharded
    int8_recip=None,                   # (S*R,) f32 row-sharded
                                       # (capacity-mode per-row dequant,
                                       # index/dense.py)
    quantized_limit: int = 64,
    dense_limit: int = 48,
    sparse_limit: int = 32,
    sparse_pool: int = 64,
    block_size: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FULL hybrid funnel over a row-sharded corpus, merged with one
    top-k of the per-shard lists.

    Each shard runs `search.fused.fused_core` — the same function the
    single-device engine runs — on its local slab (matryoshka cascade,
    int8 scan, packed-postings BM25 with global statistics
    (parallel/sparse.py), exact rescore of the deduped union), so sharded
    results match the single-device funnel by construction: with
    per-shard limits >= the single-device limits each shard's candidate
    set is a superset of the single-device candidates that live on it,
    scores come from the identical scoring path, and the merge is a plain
    top-k over comparable scores. Pass `spec` for full control
    (matryoshka dims/limits etc.); the keyword knobs build an
    int8+sparse-only spec."""
    from ..search.fused import FusedSpec, fused_core

    cap_mode = vecs is None
    i_shards = as_shards(mesh, int8, axis=axis)
    n_shards = len(i_shards)
    rps = _rows_per_shard(i_shards)
    g_valid = rps * n_shards if valid_n is None else int(valid_n)

    if spec is None:
        spec = FusedSpec(
            k=k, matryoshka_dims=(), matryoshka_limits=(),
            dense_limit=dense_limit, quantized_limit=quantized_limit,
            sparse_limit=sparse_limit, sparse_pool=sparse_pool,
            rrf_k=60, block_size=block_size, recall_target=1.0,
            use_int8=quantized_limit > 0)
    has_sparse = spec.sparse_limit > 0 and post_packed is not None
    spec = spec._replace(
        k=k,
        block_size=min(spec.block_size, rps),
        # per-shard slabs run the plain blocked scan (the fused scan
        # kernel is the single-device path), as the reference's shards
        # run the XLA scan
        scan_impl="xla", scan_prefix_dim=0,
        sparse_limit=spec.sparse_limit if has_sparse else 0,
        has_filter=filter_mask is not None,
        matryoshka_dims=() if cap_mode else spec.matryoshka_dims,
        # shard-local RRF ranks are not globally comparable (a shard's
        # rank-1 may be the global rank-50), so the sharded funnel
        # always merges exact dense scores; final_fusion="rrf" is a
        # single-device serving feature (weak-encoder rescue)
        final_fusion="dense",
    )
    if spec.matryoshka_dims and inv_norms is None:
        raise ValueError("matryoshka cascade needs inv_norms")

    def shards_of(x, stacked=False):
        return (None if x is None
                else as_shards(mesh, x, axis=axis, stacked=stacked))

    v_shards = shards_of(vecs)
    inv_shards = shards_of(inv_norms)
    live_shards = shards_of(live)
    fm_shards = shards_of(filter_mask)
    use_recip = cap_mode and int8_recip is not None
    recip_shards = shards_of(int8_recip) if use_recip else None
    post_shards = shards_of(post_packed, True) if has_sparse else None
    doc_shards = shards_of(doc_packed, True) if has_sparse else None

    vals_l, idx_l = [], []
    for s, i8_s in enumerate(i_shards):
        dev = i8_s.device
        start = s * rps
        local_valid = min(max(g_valid - start, 0), rps)
        inv_s = (inv_shards[s] if inv_shards is not None else
                 torch.zeros((rps, 0), dtype=torch.float32, device=dev))
        sparse_arrays = sparse_queries = None
        if spec.sparse_limit:
            sparse_arrays = (post_shards[s], None, doc_shards[s])
            sparse_queries = tuple(_replicated(x, dev)
                                   for x in (q_rows, q_terms, q_valid))
        top, ids = fused_core(
            v_shards[s] if v_shards is not None else None, i8_s, inv_s,
            live_shards[s], local_valid, _replicated(queries, dev),
            fm_shards[s] if spec.has_filter else None,
            sparse_arrays, sparse_queries, spec,
            int8_recip=recip_shards[s] if use_recip else None)
        vals_l.append(top)
        idx_l.append(torch.where(ids != INVALID_ID, ids + start, INVALID_ID))
    kk = vals_l[0].shape[-1]
    out_v, out_i = merge_shards(mesh, vals_l, idx_l, min(k, n_shards * kk))
    return out_v, torch.where(torch.isfinite(out_v), out_i, INVALID_ID)


def sharded_topk_dryrun(mesh: Mesh) -> None:
    """Tiny-shape execution of the sharded search path (driver dry run),
    on the mesh's devices."""
    axis = "data"
    n_shards = mesh.shape[axis]
    dev = mesh.first
    rng = np.random.default_rng(0)
    n, d, q, k = n_shards * 32, 64, 4, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = corpus[:q] + 0.01 * rng.standard_normal((q, d)).astype(np.float32)
    queries_t = torch.from_numpy(queries)

    sharded = shard_corpus(mesh, corpus, axis=axis)
    vals, idx = sharded_topk(mesh, sharded, queries_t, k,
                             axis=axis, valid_n=n, approx=False)
    idx = idx.cpu().numpy()
    assert (idx[:, 0] == np.arange(q)).all(), f"self-retrieval failed: {idx[:, 0]}"

    # the two-stage sharded funnel (int8 scan -> exact rescore -> merge)
    int8 = np.clip(np.round(corpus * 127), -127, 127).astype(np.int8)
    int8_sharded = shard_rows(mesh, int8, axis=axis)
    v2, i2 = sharded_hybrid_topk(mesh, sharded, int8_sharded, queries_t, k,
                                 axis=axis, candidates=8, block_size=32)
    i2 = i2.cpu().numpy()
    assert (i2[:, 0] == np.arange(q)).all(), f"hybrid shard failed: {i2[:, 0]}"

    # the FULL sharded funnel: dense + local BM25 + exact rescore + merge
    from ..config import SparseConfig
    from ..index.sparse import SparseIndex
    from .sparse import build_sharded_sparse

    words = "fox dog tensor unit sparse dense graph node".split()
    sparse = SparseIndex(SparseConfig(candidate_pool=32, max_query_terms=8),
                         device=dev)
    sparse.add_batch([" ".join(rng.choice(words, size=5)) for _ in range(n)])
    sh = build_sharded_sparse(sparse, n_shards)
    live = shard_rows(mesh, np.ones((n,), dtype=bool), axis=axis)
    q_rows, q_terms, q_valid = sparse.encode_queries(["fox dog"] * q)
    v3, i3 = sharded_fused_hybrid(
        mesh, sharded, int8_sharded, None, live, sh["post_packed"],
        sh["doc_packed"], queries_t, q_rows, q_terms, q_valid, k,
        axis=axis, quantized_limit=8, dense_limit=8, sparse_limit=4,
        sparse_pool=32, block_size=32)
    i3 = i3.cpu().numpy()
    assert (i3[:, 0] == np.arange(q)).all(), f"full funnel failed: {i3[:, 0]}"

    # capacity mode (vecs=None): int8-only shards, dequantized rescore
    v4, i4 = sharded_fused_hybrid(
        mesh, None, int8_sharded, None, live, sh["post_packed"],
        sh["doc_packed"], queries_t, q_rows, q_terms, q_valid, k,
        axis=axis, quantized_limit=8, dense_limit=8, sparse_limit=4,
        sparse_pool=32, block_size=32)
    i4 = i4.cpu().numpy()
    assert (i4[:, 0] == np.arange(q)).all(), f"capacity funnel failed: {i4[:, 0]}"

    # the matryoshka cascade + int8 + packed-postings BM25 through the
    # shared fused_core (the spec path)
    from ..search.fused import FusedSpec

    inv = np.stack([
        1.0 / np.maximum(np.linalg.norm(corpus[:, :16], axis=-1), 1e-12),
        np.ones(n, dtype=np.float32),
    ], axis=1).astype(np.float32)
    full_spec = FusedSpec(
        k=k, matryoshka_dims=(16, d), matryoshka_limits=(16, 8),
        dense_limit=8, quantized_limit=8, sparse_limit=4, sparse_pool=32,
        rrf_k=60, block_size=32, recall_target=1.0)
    v5, i5 = sharded_fused_hybrid(
        mesh, sharded, int8_sharded, inv, live, sh["post_packed"],
        sh["doc_packed"], queries_t, q_rows, q_terms, q_valid, k,
        axis=axis, spec=full_spec)
    i5 = i5.cpu().numpy()
    assert (i5[:, 0] == np.arange(q)).all(), \
        f"cascade funnel failed: {i5[:, 0]}"

    # sharded IVF (parallel/ivf.py): per-shard partitions + one merge
    from ..config import IndexConfig
    from ..index.dense import DenseIndex
    from .ivf import build_sharded_ivf, place_sharded_ivf, sharded_ivf_search

    dense = DenseIndex(IndexConfig(dim=d, matryoshka_dims=(),
                                   initial_capacity=max(n, 64)), device=dev)
    dense.insert(corpus)
    stacked = build_sharded_ivf(dense, n_shards, n_clusters=4,
                                bucket_rows=8, iters=3, block_rows=32)
    placed = place_sharded_ivf(mesh, stacked)
    rps = stacked["rows_per_shard"]
    pad = n_shards * rps - n
    vs = torch.nn.functional.pad(dense.vecs[:n], (0, 0, 0, pad))
    v6, i6 = sharded_ivf_search(mesh, placed, queries_t, k, probes=4,
                                rescore_vecs=shard_rows(mesh, vs, axis=axis))
    i6 = i6.cpu().numpy()
    assert (i6[:, 0] == np.arange(q)).all(), f"sharded ivf failed: {i6[:, 0]}"
