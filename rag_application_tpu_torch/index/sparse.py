"""Host-side BM25 index builder feeding the device kernels.

Port of `rag_application_tpu/index/sparse.py`. Documents are analyzed
on the host into (term, tf) arrays; `rebuild()` materializes two dense
device views with vectorized numpy (the host CSR build is the
reference's, copied):

  * term-major: (V_pad, P) impact-ordered postings (doc ids + weights,
    or the packed `(impact_q10 << 21) | doc` layout)
  * doc-major:  (N+1, 2L) per-doc top-L term ids + bitcast f32 BM25
    weights (exact-rescore view), expanded on the device from the
    (term << 16 | tf) matrix by `_expand_core`

Inserts/deletes mark the index dirty; the next search rebuilds.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import SparseConfig
from ..ops.bm25 import bm25_topk
from ..utils import DeviceLike, resolve_device, round_up
from .analyzer import Analyzer


def bm25_idf(n_docs: int, df: np.ndarray) -> np.ndarray:
    """Lucene/fastembed BM25 idf: ln(1 + (N - df + 0.5)/(df + 0.5))."""
    return np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))


def pd_unique(a: np.ndarray) -> np.ndarray:
    """First-occurrence-order unique for small int arrays (query terms)."""
    _, idx = np.unique(a, return_index=True)
    return a[np.sort(idx)]


def _expand_core(packed_tt: torch.Tensor, lens: torch.Tensor,
                 idf: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """(term<<16 | tf) int32 (N, L) -> interleaved doc-major view
    (N, 2L): term ids (cols :L, empty = -1) + bitcast f32 BM25 weights.

    The reference's f32 formula and op order; the term is a LOGICAL shift
    (`jax.lax.shift_right_logical`), so the arithmetic `>>` is masked.
    `consts` = [avgdl, k1, b] f32.
    """
    term = (packed_tt >> 16) & 0xFFFF
    tf = (packed_tt & 0xFFFF).float()
    avgdl, k1, b = consts[0], consts[1], consts[2]
    dl = lens[:, None]
    w = (idf[term.long()] * tf) * (k1 + 1.0) / (
        tf + k1 * ((1.0 - b) + (b * dl) / avgdl))
    empty = packed_tt == 0
    terms_out = torch.where(empty, -1, term).to(torch.int32)
    w_out = torch.where(empty, 0.0, w).float()
    return torch.cat([terms_out, w_out.view(torch.int32)], dim=-1)


# row-block budget for the doc-major expansion, expressed as rows*L
# (~128 MB of int32 at the default L=32)
_EXPAND_BLOCK_ROWS_L = 32 << 20


class SparseIndex:
    def __init__(self, config: Optional[SparseConfig] = None,
                 analyzer: Optional[Analyzer] = None, *,
                 device: DeviceLike = None):
        self.cfg = config or SparseConfig()
        self.device = resolve_device(device)
        if analyzer is None:
            from .native_analyzer import make_analyzer

            analyzer = make_analyzer()  # C analyzer when buildable
        self.analyzer = analyzer
        # Host state: chunked CSR, row-aligned with the dense index. Each
        # add call appends ONE chunk of flat (term, tf) pairs plus per-doc
        # unique-term counts and token lengths; `_flat()` consolidates the
        # chunks on demand.
        self._chunk_terms: List[np.ndarray] = []   # int32 flat unique terms
        self._chunk_tfs: List[np.ndarray] = []     # int32 matching tfs
        self._chunk_counts: List[np.ndarray] = []  # int32 unique terms/doc
        self._chunk_lens: List[np.ndarray] = []    # int32 tokens/doc
        self._n_docs = 0
        self._flat_cache: Optional[Tuple[np.ndarray, ...]] = None
        self._deleted: Set[int] = set()
        self._dirty = True
        self._device: Optional[dict] = None

    # ------------------------------------------------------------------ host

    def __len__(self) -> int:
        return self._n_docs

    def _append_chunk(self, terms: np.ndarray, tfs: np.ndarray,
                      counts: np.ndarray, lens: np.ndarray) -> None:
        self._chunk_terms.append(np.asarray(terms, dtype=np.int32))
        self._chunk_tfs.append(np.asarray(tfs, dtype=np.int32))
        self._chunk_counts.append(np.asarray(counts, dtype=np.int32))
        self._chunk_lens.append(np.asarray(lens, dtype=np.int32))
        self._n_docs += len(self._chunk_counts[-1])
        self._flat_cache = None
        self._dirty = True

    def _flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(terms, tfs, counts, lens) over ALL docs (incl. tombstoned)."""
        if self._flat_cache is None:
            z = np.zeros(0, dtype=np.int32)
            self._flat_cache = (
                np.concatenate(self._chunk_terms) if self._chunk_terms else z,
                np.concatenate(self._chunk_tfs) if self._chunk_tfs else z,
                np.concatenate(self._chunk_counts) if self._chunk_counts else z,
                np.concatenate(self._chunk_lens) if self._chunk_lens else z,
            )
        return self._flat_cache

    def is_deleted(self, row: int) -> bool:
        return row in self._deleted

    def add(self, text: str) -> int:
        """Analyze + append one document; returns its row id."""
        tids = np.asarray(self.analyzer.encode(text, grow=True), dtype=np.int64)
        terms, tfs = (
            np.unique(tids, return_counts=True)
            if tids.size
            else (np.zeros(0, np.int64), np.zeros(0, np.int64))
        )
        row = self._n_docs
        self._append_chunk(terms, tfs,
                           np.array([terms.size], dtype=np.int32),
                           np.array([tids.size], dtype=np.int32))
        return row

    def add_batch(self, texts: Sequence[str]) -> List[int]:
        encode_batch = getattr(self.analyzer, "encode_batch", None)
        if encode_batch is None:
            return [self.add(t) for t in texts]
        # native fast path: one C call for the whole batch, then one
        # lexsort over the flat token stream for per-doc unique+counts
        flat, offsets = encode_batch(texts, grow=True)
        start = self._n_docs
        n = len(texts)
        tok_counts = np.diff(np.asarray(offsets, dtype=np.int64))
        flat = np.asarray(flat, dtype=np.int64)
        if flat.size:
            doc_ids = np.repeat(np.arange(n, dtype=np.int64), tok_counts)
            order = np.lexsort((flat, doc_ids))
            d_s, t_s = doc_ids[order], flat[order]
            new_first = np.empty(t_s.size, dtype=bool)
            new_first[0] = True
            np.logical_or(d_s[1:] != d_s[:-1], t_s[1:] != t_s[:-1],
                          out=new_first[1:])
            pos = np.flatnonzero(new_first)
            terms = t_s[pos]
            tfs = np.append(pos[1:], t_s.size) - pos
            counts = np.bincount(d_s[pos], minlength=n)
        else:
            terms = tfs = np.zeros(0, dtype=np.int64)
            counts = np.zeros(n, dtype=np.int64)
        self._append_chunk(terms, tfs, counts, tok_counts)
        return list(range(start, start + n))

    def add_pretokenized(self, token_matrix: np.ndarray,
                         lengths: Optional[np.ndarray] = None) -> List[int]:
        """Bulk-add documents given as a (N, L) int token-id matrix.

        The vectorized ingest path for corpora whose tokenization happens
        upstream (or in the native tokenizer): per-row unique+counts are
        computed with one sort over the whole matrix. Pad slots must be -1.
        Callers are responsible for having registered the corresponding
        vocabulary in ``self.analyzer.vocab`` if text queries should match.
        """
        tm = np.asarray(token_matrix, dtype=np.int64)
        n, l = tm.shape
        s = np.sort(tm, axis=1)
        start = self._n_docs
        new_first = np.concatenate(
            [np.ones((n, 1), dtype=bool), s[:, 1:] != s[:, :-1]], axis=1
        )
        valid = s >= 0
        new_first &= valid
        # run lengths in flat coordinates: a run ends at the next
        # first-occurrence or its row boundary (pads sort to the FRONT of
        # each row, so the tail of every row is a valid run)
        flat_pos = np.flatnonzero(new_first.ravel())
        terms = s.ravel()[flat_pos]
        row_idx = flat_pos // l
        ends = np.minimum(np.append(flat_pos[1:], n * l), (row_idx + 1) * l)
        tfs = ends - flat_pos
        counts = new_first.sum(axis=1)
        lens = valid.sum(axis=1)
        self._append_chunk(terms, tfs, counts, lens)
        return list(range(start, start + n))

    def delete(self, row: int) -> None:
        """Tombstone a row (parity: page-level DETACH DELETE re-ingest,
        IndexerAPI neo4j_handler.py:161-169)."""
        self._deleted.add(row)
        self._dirty = True

    # ---------------------------------------------------------------- build

    def _live_mask(self) -> np.ndarray:
        live_mask = np.ones(self._n_docs, dtype=bool)
        if self._deleted:
            live_mask[np.fromiter(self._deleted, dtype=np.int64)] = False
        return live_mask

    def _flat_triplets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Live (row, term, tf) triplets as flat arrays."""
        terms, tfs, counts, _ = self._flat()
        rows = np.repeat(
            np.arange(self._n_docs, dtype=np.int64), counts)
        if self._deleted:
            keep = np.repeat(self._live_mask(), counts)
            rows, terms, tfs = rows[keep], terms[keep], tfs[keep]
        return rows, terms.astype(np.int64), tfs.astype(np.int64)

    def _stats(self):
        rows, terms, tfs = self._flat_triplets()
        v = len(self.analyzer)
        live = self._n_docs - len(self._deleted)
        _, _, _, lens = self._flat()
        doc_lens = lens.astype(np.float64)
        total = doc_lens[self._live_mask()].sum() if live else 0.0
        avgdl = (total / live) if live else 1.0
        df = np.bincount(terms, minlength=max(v, 1))
        idf = bm25_idf(max(live, 1), df)
        return rows, terms, tfs, idf, avgdl, live

    def _weights(self, rows, tfs, idf_terms, avgdl):
        k1, b = self.cfg.k1, self.cfg.b
        _, _, _, lens = self._flat()
        # f32 throughout: the device consumes f32/f16/10-bit views anyway,
        # and at 20M+ triplets the f64 intermediates double both the
        # arithmetic and the sort-key memory traffic
        dl = lens.astype(np.float32)[rows]
        tf = tfs.astype(np.float32)
        return (idf_terms.astype(np.float32) * tf * np.float32(k1 + 1.0)
                / (tf + np.float32(k1) * (np.float32(1.0 - b)
                                          + np.float32(b) * dl
                                          / np.float32(avgdl))))

    def rebuild(self) -> None:
        cfg = self.cfg
        n = self._n_docs
        v = len(self.analyzer)
        v_pad = max(256, 1 << math.ceil(math.log2(v + 1))) if v else 256

        rows, terms, tfs, idf, avgdl, live = self._stats()
        w = self._weights(rows, tfs, idf[terms], avgdl) if rows.size else rows.astype(np.float64)

        # --- term-major postings: sort by (term, -weight), rank within term
        if rows.size:
            order = np.lexsort((-w, terms))
            t_sorted, r_sorted, w_sorted = terms[order], rows[order], w[order]
            term_start = np.searchsorted(t_sorted, np.arange(v), side="left")
            rank = np.arange(t_sorted.size) - term_start[t_sorted]
            max_plen = int(np.bincount(t_sorted, minlength=1).max()) if t_sorted.size else 1
        else:
            t_sorted = r_sorted = rank = np.zeros(0, dtype=np.int64)
            w_sorted = np.zeros(0, dtype=np.float64)
            max_plen = 1
        p = max(128, min(cfg.max_postings_per_term, round_up(max_plen, 128)))
        keep = rank < p
        if n + 1 <= 1 << 21:
            # packed postings: (impact quantized to 10 bits << 21) | doc id
            # — one int32 per posting, so stage 1 is a single gather and
            # ranks candidates by bitcasting the ints to f32 (monotone for
            # positive int32). Exactness is unaffected: stage 2 rescores
            # from the f32 doc-major view; the 10 bits only order the
            # pool cutoff. Corpora beyond 2^21-1 docs per shard fall back
            # to the two-array layout.
            w_keep = w_sorted[keep]
            wmax = float(w_keep.max()) if w_keep.size else 1.0
            # cap at 1019: wq >= 1020 puts the packed int32 in the f32
            # Inf/NaN exponent range (0x7F800000+), and NaN compares
            # false in approx_max_k — the TOP-impact postings would be
            # silently excluded from the candidate pool
            wq = np.clip(np.ceil(w_keep / max(wmax, 1e-12) * 1019.0),
                         1, 1019).astype(np.int64)
            post_docs = np.full((v_pad, p), n, dtype=np.int32)  # impact 0
            post_docs[t_sorted[keep], rank[keep]] = (
                (wq << 21) | r_sorted[keep]).astype(np.int32)
            post_w = None
        else:
            post_docs = np.full((v_pad, p), n, dtype=np.int32)
            # f16 is plenty for impact-ordered candidate generation (exact
            # scores come from the f32 doc-major view) and halves the
            # host->device transfer of the largest array.
            post_w = np.zeros((v_pad, p), dtype=np.float16)
            post_docs[t_sorted[keep], rank[keep]] = r_sorted[keep]
            post_w[t_sorted[keep], rank[keep]] = w_sorted[keep]

        # --- doc-major view: per-doc terms ranked by -weight. Ranking
        # only matters when a doc TRUNCATES (unique terms > L) — below
        # that the match kernel sums whatever order the row holds, and
        # the triplets are already row-grouped (CSR), so the common case
        # needs no sort at all.
        if rows.size:
            _, _, all_counts, _ = self._flat()
            counts_live = np.where(self._live_mask(), all_counts, 0) \
                if self._deleted else all_counts
            max_dlen = int(counts_live.max()) if counts_live.size else 1
        else:
            counts_live = np.zeros(n, dtype=np.int64)
            max_dlen = 1
        l = max(32, min(cfg.max_terms_per_doc, round_up(max_dlen, 32)))
        if rows.size and max_dlen > l:
            order = np.lexsort((-w, rows))
            r2, t2, w2 = rows[order], terms[order], w[order]
            row_start = np.searchsorted(r2, np.arange(n), side="left")
            rank2 = np.arange(r2.size) - row_start[r2]
        elif rows.size:
            r2, t2, w2 = rows, terms, w
            starts = np.concatenate(
                [[0], np.cumsum(counts_live)[:-1]]).astype(np.int64)
            rank2 = np.arange(r2.size) - np.repeat(starts, counts_live)
        else:
            r2 = t2 = rank2 = np.zeros(0, dtype=np.int64)
            w2 = np.zeros(0, dtype=np.float32)
        keep2 = rank2 < l
        # Device-expanded doc-major view: upload one (N+1, L) int32 of
        # (term << 16 | tf) and compute the f32 BM25 weights on device
        # (_expand_core), in row blocks so the transients stay ~100 MB.
        # Needs term ids and tfs to fit 16 bits each; larger
        # vocabularies/term frequencies fall back to the host layout.
        if rows.size and max_dlen > l:
            tf2 = tfs[order]  # same impact order as r2/t2/w2
        elif rows.size:
            tf2 = tfs
        else:
            tf2 = np.zeros(0, dtype=np.int64)
        can_pack16 = (v_pad <= (1 << 16)
                      and (int(tfs.max()) <= 0xFFFF if rows.size else True))
        if can_pack16:
            packed_tt = np.zeros((n + 1, l), dtype=np.int32)
            packed_tt[r2[keep2], rank2[keep2]] = (
                (t2[keep2].astype(np.int64) << 16)
                | tf2[keep2].astype(np.int64)).astype(np.uint32) \
                .view(np.int32)
            idf_pad = np.zeros(v_pad, dtype=np.float32)
            idf_pad[: len(idf)] = idf.astype(np.float32)
            _, _, _, lens_all = self._flat()
            lens_dev = np.zeros(n + 1, dtype=np.float32)
            lens_dev[:n] = lens_all.astype(np.float32)
            consts = np.asarray(
                [np.float32(avgdl), self.cfg.k1, self.cfg.b],
                dtype=np.float32)
            total = n + 1
            blk = max(1, _EXPAND_BLOCK_ROWS_L // max(l, 1))
            dev = self.device
            idf_dev = torch.from_numpy(idf_pad).to(dev)
            consts_dev = torch.from_numpy(consts).to(dev)
            doc_packed = torch.empty((total, 2 * l), dtype=torch.int32,
                                     device=dev)
            for s in range(0, total, blk):
                doc_packed[s:s + blk] = _expand_core(
                    torch.from_numpy(packed_tt[s:s + blk]).to(dev),
                    torch.from_numpy(lens_dev[s:s + blk]).to(dev),
                    idf_dev, consts_dev)
        else:
            doc_terms = np.full((n + 1, l), -1, dtype=np.int32)
            doc_w = np.zeros((n + 1, l), dtype=np.float32)
            doc_terms[r2[keep2], rank2[keep2]] = t2[keep2]
            doc_w[r2[keep2], rank2[keep2]] = w2[keep2]

            # interleave terms + bitcast weights: one packed row per doc
            doc_packed = torch.from_numpy(np.concatenate(
                [doc_terms, doc_w.astype(np.float32).view(np.int32)],
                axis=-1)).to(self.device)
        self._device = {
            "post_docs": torch.from_numpy(post_docs).to(self.device),
            "post_weights": (torch.from_numpy(post_w).to(self.device)
                             if post_w is not None else None),
            "doc_packed": doc_packed,
            "v_pad": v_pad,
        }
        self._dirty = False

    def device_arrays(self) -> dict:
        if self._dirty:
            self.rebuild()
        return self._device

    # ---------------------------------------------------------------- query

    def encode_queries(self, queries: Sequence[str]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Queries -> (q_rows, q_terms, q_valid) on the index device,
        fixed width T."""
        t = self.cfg.max_query_terms
        dv = self.device_arrays()
        v_pad = dv["v_pad"]
        n = len(queries)
        q_rows = np.full((n, t), v_pad - 1, dtype=np.int32)
        q_terms = np.full((n, t), -2, dtype=np.int32)
        q_valid = np.zeros((n, t), dtype=bool)
        encode_batch = getattr(self.analyzer, "encode_batch", None)
        if encode_batch is not None:
            flat, offsets = encode_batch(queries, grow=False)
            for i in range(n):
                seg = flat[offsets[i]:offsets[i + 1]]
                # first occurrence order, truncated to T
                tids = pd_unique(seg)[:t] if seg.size else seg
                m = len(tids)
                q_rows[i, :m] = tids
                q_terms[i, :m] = tids
                q_valid[i, :m] = True
        else:
            for i, qtext in enumerate(queries):
                tids = list(dict.fromkeys(
                    self.analyzer.encode(qtext, grow=False)))[:t]
                for j, tid in enumerate(tids):
                    q_rows[i, j] = tid
                    q_terms[i, j] = tid
                    q_valid[i, j] = True
        dev = self.device
        return (torch.from_numpy(q_rows).to(dev),
                torch.from_numpy(q_terms).to(dev),
                torch.from_numpy(q_valid).to(dev))

    def search(self, queries: Sequence[str], k: int, *, filter_mask=None,
               approx: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """BM25 top-k. Returns (scores (Q,k), rows (Q,k)); empty slots have
        row == len(self) and score -inf."""
        dv = self.device_arrays()
        q_rows, q_terms, q_valid = self.encode_queries(queries)
        if filter_mask is not None:
            filter_mask = torch.as_tensor(filter_mask, device=self.device)
        scores, ids = bm25_topk(
            dv["post_docs"], dv["post_weights"], dv["doc_packed"],
            q_rows, q_terms, q_valid, k,
            pool=self.cfg.candidate_pool,
            filter_mask=filter_mask,
            approx=approx,
        )
        return scores.cpu().numpy(), ids.cpu().numpy()

    # ------------------------------------------------------------ reference

    def exact_scores(self, query: str) -> np.ndarray:
        """Exact host-side BM25 scores for every doc (test oracle)."""
        qtids = set(self.analyzer.encode(query, grow=False))
        n = self._n_docs
        rows, terms, tfs, idf, avgdl, live = self._stats()
        out = np.zeros(n, dtype=np.float64)
        if not rows.size or not qtids:
            return out
        mask = np.isin(terms, list(qtids))
        w = self._weights(rows[mask], tfs[mask], idf[terms[mask]], avgdl)
        np.add.at(out, rows[mask], w)
        return out
