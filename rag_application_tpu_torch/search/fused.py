"""The hybrid query funnel: matryoshka cascade, int8 scan, BM25, exact
rescore and final fusion over one query batch.

Port of `rag_application_tpu/search/fused.py`. The JAX package traces the
funnel into one XLA program; PyTorch runs eagerly, so `fused_core` is a
plain function on device tensors and a query batch is one call of it.
The tokens wire (`bind_encoder`, `search_tokens*`) runs the bound text
encoder's forward and then `fused_core` back to back on the device, with
only int32 token ids uploaded.

`FusedSpec.scan_impl` keeps the reference's values, with their port
meaning:

  * ``"xla"``    -> `ops.topk.blocked_topk`, the plain blocked search;
  * ``"pallas"`` -> `ops.fused_topk.fused_scan_topk`, the fused scan
    (`csrc/fused_scan.cu` on CUDA, its plain version on the CPU);
  * ``"auto"``   -> ``"pallas"`` when the index lives on CUDA, ``"xla"``
    when it lives on the CPU.

Every top-k is `ops.topk.stable_topk` (the reference's tie order) and
the rrf ranks use stable argsorts, as `jnp.argsort` is stable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import FunnelConfig
from ..ops.bm25 import bm25_topk
from ..ops.fused_topk import fused_scan_topk
from ..ops.quant import quantize_int8
from ..ops.rrf import INVALID_ID, first_occurrence_mask
from ..ops.topk import NEG_INF, blocked_topk, gather_rescore, stable_topk


class FusedSpec(NamedTuple):
    """Static configuration of one funnel variant."""

    k: int
    matryoshka_dims: Tuple[int, ...]  # () disables the cascade
    matryoshka_limits: Tuple[int, ...]
    dense_limit: int
    quantized_limit: int
    sparse_limit: int  # 0 disables the sparse branch
    sparse_pool: int
    rrf_k: int
    block_size: int
    recall_target: float
    use_int8: bool = True
    has_filter: bool = False
    # "xla": blocked_topk; "pallas": the fused scan (module docstring)
    scan_impl: str = "xla"
    scan_block_rows: int = 8192
    # >0: the int8 candidate scan reads the contiguous prefix table
    # (IndexConfig.scan_prefix_dim) instead of the full-dim int8 copy
    scan_prefix_dim: int = 0
    # top-k of the scan's candidate sheet (exact in the port)
    scan_approx_sheet: bool = False
    # >0: query tile of the scan (padding only in the port)
    scan_q_block: int = 0
    # >1: column strips per scan block
    scan_strips: int = 1
    # each strip emits its own 128 survivors
    scan_strip_outputs: bool = False
    # "dense" | "rrf" | "dbsf" (FunnelConfig.final_fusion)
    final_fusion: str = "dense"

    @classmethod
    def from_funnel(cls, f: FunnelConfig, dims: Tuple[int, ...], *,
                    k: int, block_size: int, use_sparse: bool,
                    use_matryoshka: bool, has_filter: bool,
                    sparse_pool: int = 1024,
                    recall_target: float = 0.95,
                    scan_impl: str = "xla") -> "FusedSpec":
        return cls(
            k=k,
            matryoshka_dims=tuple(dims) if use_matryoshka else (),
            matryoshka_limits=tuple(f.matryoshka_limits),
            dense_limit=f.dense_limit,
            quantized_limit=f.quantized_limit,
            sparse_limit=f.sparse_limit if use_sparse else 0,
            sparse_pool=sparse_pool,
            rrf_k=f.rrf_k,
            block_size=block_size,
            recall_target=recall_target,
            has_filter=has_filter,
            scan_impl=scan_impl,
            use_int8=f.quantized_limit > 0,
            final_fusion=getattr(f, "final_fusion", "dense"),
        )


def _prefix_rescore(vecs, inv_norms, q, ids, valid, dim: int, level: int,
                    keep: int):
    """Rescore candidate ids in the matryoshka view at `level`, keep top."""
    safe = torch.where(valid, ids, 0)
    scores = gather_rescore(vecs[:, :dim], q[:, :dim], safe)
    scores = scores * inv_norms[safe.long(), level]
    scores = torch.where(valid, scores, NEG_INF)
    top, pos = stable_topk(scores, min(keep, ids.shape[-1]))
    return top, torch.gather(ids, -1, pos)


def _exact_rescore(vecs, q, ids, valid, keep: int):
    safe = torch.where(valid, ids, 0)
    scores = torch.where(valid, gather_rescore(vecs, q, safe), NEG_INF)
    top, pos = stable_topk(scores, min(keep, ids.shape[-1]))
    return top, torch.gather(ids, -1, pos)


def fused_core(
    vecs: Optional[torch.Tensor],        # (cap, d) bf16 normalized
    int8: Optional[torch.Tensor],        # (cap, d) int8
    inv_norms: torch.Tensor,             # (cap, M) f32
    live: Optional[torch.Tensor],        # (cap,) bool; None = all live
    valid_n: int,                        # logical size
    queries: torch.Tensor,               # (Q, d) (unnormalized ok)
    filter_mask: Optional[torch.Tensor],  # (cap,) bool or None
    sparse_arrays: Optional[Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]],
    sparse_queries: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]],
    spec: FusedSpec,
    prefix_int8: Optional[torch.Tensor] = None,  # (cap, scan_prefix_dim)
    int8_recip: Optional[torch.Tensor] = None,   # (cap,) capacity-mode
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The funnel body. Returns (scores (Q, k) f32, ids (Q, k) int32);
    invalid slots have score -inf and id INVALID_ID."""
    q = queries.float()
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    # capacity mode (no bf16 plane): the int8 table doubles as the
    # exact-rescore source, scaled per row (int8_recip) or by 1/127
    rescore_table = vecs if vecs is not None else int8
    cap_scaled = vecs is None and int8_recip is not None
    rescore_scale = 1.0 if vecs is not None else 1.0 / 127.0
    qb = q.to(vecs.dtype) if vecs is not None else q

    def candidate_rescale(safe_ids):
        """Per-candidate dequantization factor for gathered rescores."""
        if cap_scaled:
            return int8_recip[safe_ids.long()]
        return rescore_scale

    mask = live
    if spec.has_filter and filter_mask is not None:
        mask = filter_mask if mask is None else mask & filter_mask

    def corpus_scan(table, qs, limit, *, prefix_dim=None, inv=None):
        """Full-corpus candidate scan via the selected engine."""
        if spec.scan_impl == "pallas":
            return fused_scan_topk(
                table, qs, limit,
                block_rows=spec.scan_block_rows,
                prefix_dim=prefix_dim, inv_norms=inv, mask=mask,
                approx_sheet=spec.scan_approx_sheet,
                q_block=spec.scan_q_block or None,
                strips=spec.scan_strips,
                strip_outputs=spec.scan_strip_outputs,
            )
        return blocked_topk(
            table, qs, limit,
            block_size=spec.block_size, valid_n=valid_n,
            prefix_dim=prefix_dim, inv_norms=inv, filter_mask=mask,
            approx=True, recall_target=spec.recall_target,
        )

    branches = []  # (vals, ids) candidate lists for the final union

    # --- matryoshka cascade ---
    if spec.matryoshka_dims:
        if vecs is None:
            raise ValueError("matryoshka cascade needs the bf16 plane")
        m = spec.matryoshka_limits
        vals, ids = corpus_scan(
            vecs, qb, m[0],
            prefix_dim=spec.matryoshka_dims[0], inv=inv_norms[:, 0],
        )
        for level in range(1, len(spec.matryoshka_dims)):
            if level >= len(m):
                break
            vals, ids = _prefix_rescore(
                vecs, inv_norms, q, ids, torch.isfinite(vals),
                spec.matryoshka_dims[level], level, m[level],
            )
        vals, ids = _exact_rescore(vecs, q, ids, torch.isfinite(vals),
                                   spec.dense_limit)
        branches.append((vals, ids))

    # --- int8 branch ---
    if spec.use_int8:
        if spec.scan_prefix_dim and prefix_int8 is not None:
            # prefix scan table: renormalize the query prefix too
            qp = q[:, : spec.scan_prefix_dim]
            qp = qp / torch.clamp(torch.linalg.vector_norm(
                qp, dim=-1, keepdim=True), min=1e-12)
            i_vals, i_ids = corpus_scan(prefix_int8, quantize_int8(qp),
                                        spec.quantized_limit)
            # prefix scores are coarse: refine with an exact rescore
            valid = torch.isfinite(i_vals)
            safe = torch.where(valid, i_ids, 0)
            rs = gather_rescore(rescore_table, q, safe) \
                * candidate_rescale(safe)
            rs = torch.where(valid, rs, NEG_INF)
            i_vals, pos = stable_topk(rs, min(spec.dense_limit,
                                              i_ids.shape[-1]))
            i_ids = torch.gather(i_ids, -1, pos)
        else:
            i_vals, i_ids = corpus_scan(
                int8, quantize_int8(q), spec.quantized_limit,
                inv=int8_recip if cap_scaled else None)
            # the scan's values ARE full-dim int8 dots: rank-select the
            # refine set directly from them
            i_vals, pos = stable_topk(i_vals, min(spec.dense_limit,
                                                  i_ids.shape[-1]))
            i_ids = torch.gather(i_ids, -1, pos)
        branches.append((i_vals, i_ids))

    # --- sparse BM25 branch ---
    sp_vals = sp_ids = sp_valid = None
    if spec.sparse_limit and sparse_arrays is not None:
        post_docs, post_w, doc_packed = sparse_arrays
        q_rows, q_terms, q_valid = sparse_queries
        n_sparse = doc_packed.shape[0] - 1
        # live ∧ payload filter, row-aligned (None = nothing masked)
        fm = mask[:n_sparse] if mask is not None else None
        sp_vals, sp_ids = bm25_topk(
            post_docs, post_w, doc_packed,
            q_rows, q_terms, q_valid, spec.sparse_limit,
            pool=spec.sparse_pool, filter_mask=fm,
        )
        sp_valid = torch.isfinite(sp_vals)
        branches.append((torch.where(sp_valid, 0.0, NEG_INF), sp_ids))

    # --- final exact rescore over the deduped union ---
    all_ids = torch.cat([ids.to(torch.int32) for _, ids in branches], dim=-1)
    all_valid = torch.cat([torch.isfinite(v) for v, _ in branches], dim=-1)
    all_ids = torch.where(all_valid, all_ids, INVALID_ID)
    keep = first_occurrence_mask(all_ids) & (all_ids != INVALID_ID)
    safe_ids = torch.where(keep, all_ids, 0)
    scores = gather_rescore(rescore_table, q, safe_ids) \
        * candidate_rescale(safe_ids)
    scores = torch.where(keep, scores, NEG_INF)

    if spec.final_fusion == "dbsf" and sp_ids is not None:
        # distribution-based score fusion: per-query min-max dense scores
        # over the kept union plus ratio-to-max BM25 scores
        big = 3e38
        lo = torch.amin(torch.where(keep, scores, big), dim=-1,
                        keepdim=True)
        hi = torch.amax(torch.where(keep, scores, -big), dim=-1,
                        keepdim=True)
        den = hi - lo
        dn = torch.where(den > 1e-9,
                         (scores - lo) / torch.clamp(den, min=1e-9), 1.0)
        sp_member = (all_ids[:, :, None] == sp_ids[:, None, :]) \
            & sp_valid[:, None, :]
        shi = torch.amax(torch.where(sp_valid, sp_vals, 0.0), dim=-1,
                         keepdim=True)
        s_norm = torch.clamp(sp_vals, min=0.0) / torch.clamp(shi, min=1e-9)
        sval = torch.where(sp_member, s_norm[:, None, :], 0.0).sum(dim=-1)
        # dense score as an epsilon tie-break; -inf slots stay -inf
        scores = torch.where(keep, dn + sval, NEG_INF) + \
            torch.where(keep, scores * 1e-6, scores)

    if spec.final_fusion == "rrf" and sp_ids is not None:
        # reciprocal-rank fusion of the dense-exact ranking (position of
        # each kept slot in the stable descending order) with BM25 ranks
        order = torch.argsort(-scores, dim=-1, stable=True)
        dense_rank = torch.argsort(order, dim=-1, stable=True).float()
        rrf = 1.0 / (spec.rrf_k + 1.0 + dense_rank)
        sp_member = (all_ids[:, :, None] == sp_ids[:, None, :]) \
            & sp_valid[:, None, :]
        sp_rank = sp_member.to(torch.int32).argmax(dim=-1).float()
        in_sparse = sp_member.any(dim=-1)
        rrf = rrf + torch.where(in_sparse,
                                1.0 / (spec.rrf_k + 1.0 + sp_rank), 0.0)
        scores = torch.where(keep, rrf, NEG_INF) + \
            torch.where(keep, scores * 1e-6, scores)

    top_scores, pos = stable_topk(scores, min(spec.k, all_ids.shape[-1]))
    top_ids = torch.gather(all_ids, -1, pos)
    top_ids = torch.where(torch.isfinite(top_scores), top_ids, INVALID_ID)
    return top_scores, top_ids


class FusedSearcher:
    """Binds a DenseIndex (+ optional SparseIndex) to the fused funnel."""

    def __init__(self, dense, sparse=None, funnel: Optional[FunnelConfig] = None,
                 *, scan_impl: Optional[str] = None,
                 scan_block_rows: Optional[int] = None,
                 scan_approx_sheet: Optional[bool] = None,
                 scan_q_block: Optional[int] = None,
                 scan_strips: Optional[int] = None,
                 scan_strip_outputs: Optional[bool] = None):
        # engine knobs default to the funnel config's (FunnelConfig scan_*)
        self.dense = dense
        self.sparse = sparse
        self.funnel = funnel or FunnelConfig()
        f = self.funnel
        self.scan_impl = scan_impl if scan_impl is not None else \
            getattr(f, "scan_impl", "auto")
        self.scan_block_rows = scan_block_rows if scan_block_rows is not None \
            else getattr(f, "scan_block_rows", 16384)
        self.scan_approx_sheet = scan_approx_sheet if scan_approx_sheet \
            is not None else getattr(f, "scan_approx_sheet", True)
        self.scan_q_block = scan_q_block if scan_q_block is not None else \
            getattr(f, "scan_q_block", 1024)
        self.scan_strips = scan_strips if scan_strips is not None else \
            getattr(f, "scan_strips", 1)
        self.scan_strip_outputs = scan_strip_outputs \
            if scan_strip_outputs is not None \
            else getattr(f, "scan_strip_outputs", False)

    def _resolved_engine(self) -> Tuple[str, int]:
        """(impl, block_rows) with "auto" and the dim clamp applied."""
        impl = self.scan_impl
        if impl == "auto":
            impl = "pallas" if self.dense.device.type == "cuda" else "xla"
        block = self.scan_block_rows
        d = self.dense.cfg.dim
        if impl == "pallas" and d > 768:
            # the reference's clamp for wide rows, kept for equal sheets
            block = min(block, max(4096, (16384 * 768 // d) // 128 * 128))
        return impl, block

    def prepare(self, query_embeddings, query_texts=None, *,
                upload_dtype=None):
        """Query prep + device upload, separated from execution.

        ``upload_dtype="float16"`` halves the upload bytes; ``"int8"``
        quantizes each row at 127/max|x| before the upload (the funnel
        renormalizes every query, which cancels the per-row scale)."""
        q = torch.as_tensor(query_embeddings)
        if upload_dtype == "int8":
            q32 = q.float()
            s = torch.amax(q32.abs(), dim=-1, keepdim=True)
            q = torch.clamp(torch.round(
                q32 * (127.0 / torch.clamp(s, min=1e-12))),
                -127, 127).to(torch.int8)
        elif upload_dtype is not None:
            q = q.to(getattr(torch, str(np.dtype(upload_dtype))))
        elif q.dtype not in (torch.float16, torch.float32):
            q = q.float()
        q = q.to(self.dense.device)
        sparse_queries = None
        if (self.sparse is not None and query_texts is not None
                and len(self.sparse) > 0):
            sparse_queries = self.sparse.encode_queries(list(query_texts))
        return q, sparse_queries

    def _build_spec(self, k: int, *, use_sparse: bool,
                    use_matryoshka: bool, has_filter: bool,
                    funnel: Optional[FunnelConfig]):
        """(spec, sparse_arrays) for one batch."""
        f = funnel or self.funnel
        d = self.dense
        if d.vecs is None:  # capacity mode: prefix views unavailable
            use_matryoshka = False
        sparse_arrays = None
        sparse_pool = 1024
        if use_sparse:
            dv = self.sparse.device_arrays()
            sparse_arrays = (dv["post_docs"], dv["post_weights"],
                             dv["doc_packed"])
            sparse_pool = self.sparse.cfg.candidate_pool
        impl, block_rows = self._resolved_engine()
        spec = FusedSpec.from_funnel(
            f, d.cfg.matryoshka_dims, k=k, block_size=d.cfg.block_size,
            use_sparse=use_sparse, use_matryoshka=use_matryoshka,
            has_filter=has_filter, sparse_pool=sparse_pool,
            recall_target=d.cfg.approx_recall_target,
            scan_impl=impl,
        )._replace(scan_block_rows=block_rows,
                   scan_approx_sheet=self.scan_approx_sheet,
                   scan_q_block=self.scan_q_block,
                   scan_strips=self.scan_strips,
                   scan_strip_outputs=self.scan_strip_outputs,
                   scan_prefix_dim=(d.cfg.scan_prefix_dim
                                    if d.prefix_int8 is not None else 0))
        if d.int8 is None:  # store_int8=False: no quantized scan table
            spec = spec._replace(use_int8=False)
        if not (spec.matryoshka_dims or spec.use_int8 or spec.sparse_limit):
            raise ValueError(
                "no funnel branch available: enable matryoshka (needs the "
                "bf16 plane), int8 (store_int8=True), or the sparse index")
        return spec, sparse_arrays

    def search_prepared(self, prepared, k: int = 10, *, filter_mask=None,
                        use_matryoshka: bool = True,
                        funnel: Optional[FunnelConfig] = None):
        """Run the funnel on pre-staged query tensors."""
        from ..utils.observability import METRICS

        q, sparse_queries = prepared
        METRICS.inc("search_queries", q.shape[0])
        d = self.dense
        spec, sparse_arrays = self._build_spec(
            k, use_sparse=sparse_queries is not None,
            use_matryoshka=use_matryoshka,
            has_filter=filter_mask is not None, funnel=funnel)
        # provably all-live tables drop the mask plane from the scan
        live = None if (filter_mask is None and d.fully_live) else d.live
        fm = (torch.as_tensor(filter_mask, device=d.device)
              if filter_mask is not None else None)
        return fused_core(
            d.vecs, d.int8, d.inv_norms, live, d.size, q, fm,
            sparse_arrays, sparse_queries, spec,
            prefix_int8=d.prefix_int8,
            int8_recip=getattr(d, "int8_recip", None),
        )

    # ------------------------------------------------------ tokens wire
    #
    # Clients send text. Uploading int32 token ids instead of f32 vectors
    # cuts the upload ~6x at 768-d, and the encoder forward runs on the
    # device right before the funnel.

    def bind_encoder(self, model, params, *, pad_id: int = 0) -> None:
        """Attach the on-device query encoder for the tokens wire.
        ``model.apply(params, ids, mask)`` must yield (Q, dim) embeddings
        (models/encoder.py::TextEncoder). A model that owns its weights
        (``model.owns``) must be given those weights or None."""
        owns = getattr(model, "owns", None)
        if owns is not None and not owns(params):
            raise ValueError("bind_encoder: params are not the model's own; "
                             "load them with load_state_dict")
        self._enc_model = model
        self._enc_params = params
        self._enc_pad = pad_id

    def prepare_tokens(self, token_ids, query_texts=None, attn_mask=None):
        """Upload int32 token ids (+ host-side sparse query encoding).
        ``attn_mask`` overrides the default ``ids != pad_id`` mask."""
        dev = self.dense.device
        ids = torch.as_tensor(token_ids).to(dev, torch.int32)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask).to(dev, torch.bool)
        sparse_queries = None
        if (self.sparse is not None and query_texts is not None
                and len(self.sparse) > 0):
            sparse_queries = self.sparse.encode_queries(list(query_texts))
        return ids, attn_mask, sparse_queries

    def search_tokens_prepared(self, prepared, k: int = 10, *,
                               filter_mask=None, use_matryoshka: bool = True,
                               funnel: Optional[FunnelConfig] = None):
        """Encoder forward, then the fused funnel, on the device."""
        if getattr(self, "_enc_model", None) is None:
            raise ValueError("call bind_encoder(model, params) first")
        ids, attn_mask, sparse_queries = prepared
        mask = (ids != self._enc_pad) if attn_mask is None else attn_mask
        q = self._enc_model.apply(self._enc_params, ids, mask).float()
        return self.search_prepared(
            (q, sparse_queries), k, filter_mask=filter_mask,
            use_matryoshka=use_matryoshka, funnel=funnel)

    def search_tokens(self, token_ids, query_texts=None, k: int = 10, *,
                      attn_mask=None, filter_mask=None,
                      use_matryoshka: bool = True,
                      funnel: Optional[FunnelConfig] = None):
        """Text-in search: token ids cross the wire, the device encodes
        and retrieves."""
        prepared = self.prepare_tokens(token_ids, query_texts, attn_mask)
        return self.search_tokens_prepared(
            prepared, k, filter_mask=filter_mask,
            use_matryoshka=use_matryoshka, funnel=funnel)

    def search(self, query_embeddings, query_texts=None, k: int = 10, *,
               filter_mask=None, use_matryoshka: bool = True,
               funnel: Optional[FunnelConfig] = None):
        prepared = self.prepare(query_embeddings, query_texts)
        return self.search_prepared(
            prepared, k, filter_mask=filter_mask,
            use_matryoshka=use_matryoshka, funnel=funnel)
