"""Plain reference of hybrid search: exact dense top-k and exact BM25.

Plain PyTorch (float32 products with TF32 off, float64 BM25 sums). It
imports nothing of the program and takes nothing the program made: the
corpus is drawn again from the seed (benchmark/data.py) and normalized,
rounded and scored here; BM25 statistics come from the token matrix the
benchmark made.

Exact dense top-10 is chip_smoke.py's `exact_top_ids`: the dense cosine
of the bf16-rounded normalized query over the bf16-rounded normalized
rows, in full float32 products, ties to the smaller row id.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .. import data


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _topk_smaller_id(scores: torch.Tensor, ids: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by score, ties to the smaller id (sort by id, then a stable
    sort by score)."""
    order = torch.argsort(ids, dim=-1, stable=True)
    s, i = torch.gather(scores, -1, order), torch.gather(ids, -1, order)
    order = torch.argsort(s, dim=-1, descending=True, stable=True)[:, :k]
    return torch.gather(s, -1, order), torch.gather(i, -1, order)


def _merge(best, scores: torch.Tensor, start: int, k: int):
    v, i = torch.topk(scores, min(k, scores.shape[1]), dim=-1)
    i = i + start
    if best is not None:
        v = torch.cat([best[0], v], dim=-1)
        i = torch.cat([best[1], i], dim=-1)
    return _topk_smaller_id(v, i, k)


def dense_topk(seed: int, cfg: Dict, queries: torch.Tensor, k: int,
               precision: str = "bf16") -> np.ndarray:
    """(Q, k) exact top-k row ids of ``queries`` over the seed's corpus.

    ``precision`` "bf16" is the configuration's: bf16-rounded unit rows
    and queries, float32 products. "int8" is the control one step below:
    both rounded to int8 at 127 (clip(round(127 x))), exact integer
    products."""
    dev = queries.device
    qn = queries.float()
    qn = qn / torch.linalg.vector_norm(qn, dim=-1, keepdim=True)
    q = _round(qn, precision)
    best = None
    with no_tf32():
        for s, x in data.corpus_slabs(seed, cfg["rows"], cfg["dim"],
                                      cfg["spectral_decay"], dev):
            xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            # int8 products are integers below 2^24: exact in float32
            best = _merge(best, q @ _round(xn, precision).T, s, k)
    return best[1].cpu().numpy()


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "int8":
        return torch.clamp(torch.round(x * 127.0), -127, 127)
    raise ValueError(f"unknown precision {precision!r}")


class BM25:
    """Exact BM25 (Lucene idf, k1, b) over a (N, L) token matrix, every
    document scored, in float64 (or in a lower precision for the
    control)."""

    def __init__(self, tokens: np.ndarray, vocab: int, k1: float, b: float,
                 device):
        self.device = device
        tok = torch.as_tensor(tokens, device=device).long()
        n, l = tok.shape
        self.tok, self.k1, self.b = tok, k1, b
        df = torch.zeros(vocab, dtype=torch.float64, device=device)
        # one count a (document, term): the first slot holding the term
        first = torch.ones_like(tok, dtype=torch.bool)
        for j in range(1, l):
            first[:, j] = (tok[:, :j] != tok[:, j:j + 1]).all(dim=1)
        df.index_add_(0, tok[first], torch.ones(int(first.sum()),
                                                dtype=torch.float64,
                                                device=device))
        self.idf = torch.log(1.0 + (n - df + 0.5) / (df + 0.5))
        dl = torch.full((n,), float(l), dtype=torch.float64, device=device)
        avgdl = dl.mean()
        tf = (tok[:, :, None] == tok[:, None, :]).sum(-1).double()
        self.first, self.tf, self.dl, self.avgdl = first, tf, dl, avgdl
        norm = k1 * (1.0 - b + b * dl / avgdl)
        # each slot's share of its term's weight idf * tf (k1+1) / (tf +
        # norm): the tf copies of a term in a document add up to it
        self.slot_w = self.idf[tok] * (k1 + 1.0) / (tf + norm[:, None])

    def _mask(self, qterms: np.ndarray) -> torch.Tensor:
        m = torch.zeros(self.idf.shape[0], dtype=torch.bool,
                        device=self.device)
        m[torch.as_tensor(np.unique(qterms), device=self.device).long()] = True
        return m

    def all_scores(self, qterms: np.ndarray) -> torch.Tensor:
        """(N,) float64 scores of every document."""
        m = self._mask(qterms)
        return (self.slot_w * m[self.tok]).sum(-1)

    # ------------------------------------------------ impact-ordered BM25
    #
    # The funnel's BM25 branch is BM25 over a candidate pool, as the
    # port's SparseConfig documents it: each term keeps its `keep`
    # highest-impact postings (impact = the term's float32 BM25 weight in
    # the document; ties to the smaller document id); a query's pool is
    # the `pool` highest of its terms' kept postings by impact quantized
    # to 10 bits of the largest weight (ceil(w / w_max x 1019), ties to
    # the larger document id); its hits are the pool's documents ranked
    # by their exact score. What follows computes that from the token
    # matrix alone.

    def _impacts(self, precision: str):
        """(term, doc, weight) of each distinct (document, term), the
        weight in float32 (or rounded to bf16 for the control)."""
        doc = torch.arange(self.tok.shape[0], device=self.device)
        doc = doc[:, None].expand_as(self.tok)[self.first]
        term = self.tok[self.first]
        f32 = torch.float32
        tf = self.tf[self.first].to(f32)
        dl = self.dl.to(f32)[doc]
        w = (self.idf.to(f32)[term] * tf * torch.tensor(self.k1 + 1.0,
                                                        dtype=f32)
             / (tf + torch.tensor(self.k1, dtype=f32)
                * (torch.tensor(1.0 - self.b, dtype=f32)
                   + torch.tensor(self.b, dtype=f32) * dl
                   / self.avgdl.to(f32))))
        if precision == "bf16":
            w = w.to(torch.bfloat16).float()
        return term, doc, w

    def postings(self, keep: int, precision: str = "f32") -> torch.Tensor:
        """(V, keep) int64 keys q10 * 2^21 + doc of each term's `keep`
        highest-impact postings; padding is the key N (impact 0)."""
        term, doc, w = self._impacts(precision)
        n = self.tok.shape[0]
        order = torch.argsort(doc, stable=True)
        order = order[torch.argsort(-w[order], stable=True)]
        order = order[torch.argsort(term[order], stable=True)]
        term, doc, w = term[order], doc[order], w[order]
        start = torch.searchsorted(term, torch.arange(
            self.idf.shape[0], device=self.device))
        rank = torch.arange(term.shape[0], device=self.device) - start[term]
        kept = rank < keep
        wmax = w[kept].max()
        q10 = torch.clamp(torch.ceil(w[kept] / wmax * 1019.0), 1, 1019)
        table = torch.full((self.idf.shape[0], keep), n, dtype=torch.int64,
                           device=self.device)
        table[term[kept], rank[kept]] = q10.long() * (1 << 21) + doc[kept]
        return table

    def pool_topk(self, qterms, table: torch.Tensor, pool: int, m: int,
                  precision: str = "f64"):
        """Each query's hits as the branch's semantics define them:
        (S, m) scores (float64 exact, or summed in bf16 for the control)
        and ids, best first; empty slots score 0 with id N."""
        n = self.tok.shape[0]
        out_s = np.zeros((len(qterms), m))
        out_i = np.full((len(qterms), m), n, dtype=np.int64)
        for row, q in enumerate(qterms):
            terms = torch.as_tensor(np.unique(q), device=self.device).long()
            keys = table[terms].reshape(-1)
            top = torch.topk(keys, min(pool, keys.shape[0])).values
            cand = torch.unique(top % (1 << 21))
            cand = cand[cand < n]
            mask = self._mask(q)
            w = self.slot_w[cand] * mask[self.tok[cand]]
            if precision == "bf16":
                sc = w.to(torch.bfloat16).float().sum(-1).to(
                    torch.bfloat16).double()
            else:
                sc = w.sum(-1)
            # best first, ties to the smaller id (cand is sorted)
            order = torch.argsort(-sc, stable=True)[:m]
            sc, ids = sc[order], cand[order]
            live = sc > 0
            k = int(live.sum())
            out_s[row, :k] = sc[live].cpu().numpy()
            out_i[row, :k] = ids[live].cpu().numpy()
        return out_s, out_i
