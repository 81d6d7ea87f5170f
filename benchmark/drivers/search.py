"""Closed-loop batches through the port's hybrid search entry,
`FusedSearcher.search`: one caller sends batch after batch, each waiting
for the last one's ids on the host.

The configuration gives the corpus (rows, width, matryoshka views, the
BM25 side) and the funnel; the mix gives the batch, the query noise,
whether queries carry texts (then the BM25 branch runs), and the name of
its throughput metric (`qps_metric`). Tables and
queries are made from the seed: the dense rows on the card, the token
documents and query texts on the host, as a client would send them.

After the window the plain reference (benchmark/reference/search.py)
judges a seeded sample of the window's answers: their recall of the
exact dense top-k and, where texts were sent, the sparse branch's hits,
which the driver keeps as the branch returns them: their BM25 scores and
whether they are the exact BM25 top documents.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import data, harness
from benchmark.reference import search as ref


class SparseTap:
    """Keeps what the funnel's BM25 branch returns, batch by batch, as
    device tensors (the funnel reads `bm25_topk` from its module)."""

    def __init__(self, module):
        if not callable(getattr(module, "bm25_topk", None)):
            raise RuntimeError("the funnel has no bm25_topk to read")
        self.module, self.orig, self.out = module, module.bm25_topk, []

    def __enter__(self):
        def tap(*args, **kwargs):
            result = self.orig(*args, **kwargs)
            self.out.append(result)
            return result

        self.module.bm25_topk = tap
        return self

    def __exit__(self, *exc):
        self.module.bm25_topk = self.orig


def inputs(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int, device,
           insert=None):
    """The seed's query pool (P*Q, d) as host f32 and, with texts, the
    documents' tokens and the queries' noisy tokens. ``insert`` gets each
    corpus slab as it is drawn."""
    n, d = cfg["rows"], cfg["dim"]
    src = data.query_sources(seed, n, mix["batch"] * mix["pool_batches"])
    rows = torch.empty((len(src), d), device=device)
    src_t = torch.as_tensor(src, device=device)
    for s, x in data.corpus_slabs(seed, n, d, cfg["spectral_decay"], device):
        if insert is not None:
            insert(x)
        sel = ((src_t >= s) & (src_t < s + x.shape[0])).nonzero()[:, 0]
        rows[sel] = x[src_t[sel] - s]
    pool = data.query_pool(seed, rows, mix["noise"])
    tokens = qtok = None
    if mix["texts"]:
        sp = cfg["sparse"]
        tokens = data.synth_tokens(seed, n, sp["vocab"], sp["doc_tokens"])
        qtok = data.noisy_tokens(tokens, src, seed, mix["flip"], sp["vocab"])
    return pool, tokens, qtok


def build(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int, device):
    """The program's tables over the seed's corpus and the inputs:
    (searcher, pool, texts or None, query tokens, document tokens)."""
    from rag_application_tpu_torch.config import (FunnelConfig, IndexConfig,
                                                  SparseConfig)
    from rag_application_tpu_torch.index.dense import DenseIndex
    from rag_application_tpu_torch.index.sparse import SparseIndex
    from rag_application_tpu_torch.search.fused import FusedSearcher

    dense = DenseIndex(IndexConfig(
        dim=cfg["dim"], matryoshka_dims=tuple(cfg["matryoshka_dims"]),
        initial_capacity=cfg["rows"]), device=device)
    pool, tokens, qtok = inputs(cfg, mix, seed, device, dense.insert)
    sparse = texts = None
    if tokens is not None:
        sp = cfg["sparse"]
        sparse = SparseIndex(SparseConfig(
            k1=sp["k1"], b=sp["b"], candidate_pool=sp["candidate_pool"],
            max_postings_per_term=sp["max_postings_per_term"]),
            device=device)
        sparse.analyzer.vocab = {f"w{t}": t for t in range(sp["vocab"])}
        sparse.add_pretokenized(tokens)
        sparse.rebuild()
        texts = data.texts(qtok)
    searcher = FusedSearcher(dense, sparse, FunnelConfig(**cfg["funnel"]))
    return searcher, pool, texts, qtok, tokens


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None):
    """One run of the cell. ``fault``, a test's hook, may break the
    searcher before the window (the run must then read not correct)."""
    cfg, mix = cell.config, cell.mix
    torch.set_grad_enabled(False)
    from rag_application_tpu_torch.search import fused

    searcher, pool, texts, qtok, tokens = build(cfg, mix, seed, device)
    if fault is not None:
        fault(searcher)
    q_n, k = mix["batch"], cfg["k"]
    batches = [(pool[i * q_n:(i + 1) * q_n],
                None if texts is None else texts[i * q_n:(i + 1) * q_n])
               for i in range(mix["pool_batches"])]
    for q, tx in batches[:2]:  # warm-up: the window's one shape
        searcher.search(q, tx, k)[1].cpu()
    if trace:
        harness.warm_profiler(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    ids_out: List[np.ndarray] = []
    spans: Dict[str, List[float]] = {"prepare": [], "batch": []}
    tap = SparseTap(fused) if texts is not None else None
    prof, n_traced, t_trace = None, 0, [0.0, 0.0]
    with (tap if tap is not None else contextlib.nullcontext()):
        t0 = time.perf_counter()
        while True:
            q, tx = batches[len(ids_out) % len(batches)]
            if trace and prof is None and \
                    time.perf_counter() - t0 >= seconds / 2:
                prof = harness.profiler(device)
                prof.__enter__()
                t_trace[0] = time.perf_counter()
            tb = time.perf_counter()
            if trace:
                with torch.profiler.record_function("prepare"):
                    prepared = searcher.prepare(q, tx)
                spans["prepare"].append(time.perf_counter() - tb)
                _, ids = searcher.search_prepared(prepared, k)
            else:
                _, ids = searcher.search(q, tx, k)
            ids_out.append(ids.cpu().numpy())
            te = time.perf_counter()
            spans["batch"].append(te - tb)
            if prof is not None and not t_trace[1]:
                n_traced += 1
                if n_traced >= mix["trace_batches"] or te - t0 >= seconds:
                    t_trace[1] = te
                    prof.__exit__(None, None, None)
            if te - t0 >= seconds:
                break
    window = te - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n_batches = len(ids_out)

    readings = harness.Readings(spans=spans, work={
        "queries": q_n, "rows": cfg["rows"], "dim": cfg["dim"],
        "prefix": cfg["matryoshka_dims"][0], "batches": n_batches,
        "window_s": window,
        "traced_batches": n_traced})
    if prof is not None:
        readings.trace = harness.Trace.from_profiler(
            prof, t_trace[1] - t_trace[0], annotations=("prepare",))

    # ---- after the window: the program's state goes, the reference runs
    # a batch answered in another shape: its missing answers are invalid
    ids_out = [o if o.shape == (q_n, k) else _padded(o, q_n, k)
               for o in ids_out]
    failed = sum(int(((o < 0) | (o >= cfg["rows"])).any(axis=1).sum())
                 for o in ids_out)
    sparse_out = tap.out if tap is not None else None
    del searcher, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, recall, judged = judge(cfg, mix, seed, pool, qtok, tokens,
                                   ids_out, sparse_out, device)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    e2e = {mix["qps_metric"]: q_n * n_batches / window,
           "search_p95_ms": harness.percentile(spans["batch"], 95) * 1e3,
           "recall_at_10": recall}
    notes = {"batches": n_batches, "window_s": window,
             "batch_ms_median": 1e3 * harness.percentile(spans["batch"], 50),
             **judged}
    return harness.Outcome(e2e, readings, checks, correct, q_n * n_batches,
                           failed, peak, notes), setup_s


def _padded(ids: np.ndarray, rows: int, k: int) -> np.ndarray:
    out = np.full((rows, k), -1, dtype=np.int64)
    if ids.ndim == 2:
        r, c = min(rows, ids.shape[0]), min(k, ids.shape[1])
        out[:r, :c] = ids[:r, :c]
    return out


def sample(seed: int, n_batches: int, mix: Dict[str, Any]):
    """The seeded (batch, row) positions of the window's answers that are
    judged, and the pool row each asked."""
    q_n = mix["batch"]
    flat = data.rng(seed, 20).choice(
        n_batches * q_n, size=min(mix["sample"], n_batches * q_n),
        replace=False)
    pos = np.stack([flat // q_n, flat % q_n], axis=1)
    return pos, (pos[:, 0] % mix["pool_batches"]) * q_n + pos[:, 1]


def judge(cfg, mix, seed, pool, qtok, tokens, ids_out, sparse_out, device):
    """The numbers compared, each with its limit, recall@k, and notes."""
    pos, pool_idx = sample(seed, len(ids_out), mix)
    uniq, inv = np.unique(pool_idx, return_inverse=True)
    exact = ref.dense_topk(seed, cfg, torch.as_tensor(pool[uniq],
                                                      device=device),
                           cfg["k"])[inv]
    got = np.stack([ids_out[b][r] for b, r in pos])
    recall = float(np.mean([np.isin(exact[i], got[i]).mean()
                            for i in range(len(pos))]))
    limits = mix["limits"]
    checks = [("dense_miss", 1.0 - recall, limits["dense_miss"])]
    notes = {}
    if sparse_out is not None:
        err, miss, notes = bm25_judge(cfg, tokens, qtok, pool_idx, pos,
                                      sparse_out, device)
        checks += [("bm25_score_err", err, limits["bm25_score_err"]),
                   ("bm25_topk_miss", miss, limits["bm25_topk_miss"])]
    return checks, recall, notes


# relative gap below which two BM25 scores are one to float32 sums
BM25_TIE = 1e-5


def bm25_width(cfg) -> int:
    """How many hits the funnel asks of its BM25 branch."""
    return min(cfg["funnel"]["sparse_limit"], cfg["sparse"]["candidate_pool"])


def _misses(hit: np.ndarray, best: np.ndarray):
    """(ranks missed, ranks counted): ranks whose best score is above 0
    where the hits' score falls below it by more than `BM25_TIE`."""
    need = best > 0
    return (int(((hit < best * (1.0 - BM25_TIE)) & need).sum()),
            int(need.sum()))


def bm25_judge(cfg, tokens, qtok, pool_idx, pos, sparse_out, device):
    """The sparse branch's answers against the reference, over the sampled
    queries: (score_err, topk_miss, notes).

    score_err: the largest relative gap between a hit's score as the
    branch returned it and that document's exact score. topk_miss: the
    share of the ranks of the branch's semantics (its m = `bm25_width`
    hits from the impact-ordered pool, `BM25.pool_topk`; ranks whose
    score is above 0) at which the branch's distinct hits, ranked by
    their exact scores and padded with 0, fall below that rank's score by
    more than `BM25_TIE`: tied documents stand for each other, and an
    empty or short answer misses every rank it leaves open. The notes
    give the same share against exact BM25 over every document (what
    the pool's truncation costs; not compared)."""
    sp = cfg["sparse"]
    bm = ref.BM25(tokens, sp["vocab"], sp["k1"], sp["b"], device)
    n, m = cfg["rows"], bm25_width(cfg)
    table = bm.postings(sp["max_postings_per_term"])
    want_s, _ = bm.pool_topk([qtok[pi] for pi in pool_idx], table,
                             sp["candidate_pool"], m)
    del table
    worst, missed, ranks, ex_missed, ex_ranks = 0.0, 0, 0, 0, 0
    for row, ((b, r), pi) in enumerate(zip(pos, pool_idx)):
        if b >= len(sparse_out) or r >= sparse_out[b][0].shape[0]:
            # the branch answered no such query
            return float("inf"), 1.0, {}
        scores, ids = sparse_out[b]
        s = scores[r].float().cpu().numpy()
        i = ids[r].cpu().numpy().astype(np.int64)
        ok = np.isfinite(s) & (i >= 0) & (i < n)
        exact = bm.all_scores(qtok[pi])
        hit = np.zeros(m)
        if ok.any():
            want = exact[torch.as_tensor(i[ok], device=exact.device)]
            want = want.cpu().numpy()
            err = np.abs(s[ok] - want) / np.maximum(np.abs(want), 1e-12)
            worst = max(worst, float(err.max()))
            distinct = exact[torch.as_tensor(np.unique(i[ok]),
                                             device=exact.device)]
            top = np.sort(distinct.cpu().numpy())[::-1][:m]
            hit[:len(top)] = top
        a, c = _misses(hit, want_s[row])
        missed, ranks = missed + a, ranks + c
        a, c = _misses(hit, torch.topk(exact, m).values.cpu().numpy())
        ex_missed, ex_ranks = ex_missed + a, ex_ranks + c
    return worst, missed / max(ranks, 1), {
        "bm25_exact_topk_miss": ex_missed / max(ex_ranks, 1)}


def control_checks(cell: harness.Cell, seed: int, device) -> List:
    """The control: the reference one precision step down (int8 dense
    scores, bf16 BM25 weights) put in the program's place, judged by the
    same comparison on the cell's own sizes and sample."""
    cfg, mix = cell.config, cell.mix
    n_batches = int(mix["control_batches"])
    q_n, k = mix["batch"], cfg["k"]
    pool, tokens, qtok = inputs(cfg, mix, seed, device)
    pos, pool_idx = sample(seed, n_batches, mix)
    uniq, inv = np.unique(pool_idx, return_inverse=True)
    low = ref.dense_topk(seed, cfg, torch.as_tensor(pool[uniq],
                                                    device=device), k,
                         "int8")[inv]
    # the control's answers, laid out as the window's batches
    ids_out = [np.zeros((q_n, k), np.int32) for _ in range(n_batches)]
    for (b, r), row in zip(pos, low):
        ids_out[b][r] = row
    sparse_out = None
    if tokens is not None:
        sparse_out = _bm25_answers(cfg, tokens, qtok, pool_idx, pos,
                                   n_batches, q_n, device)
    checks, _, _ = judge(cfg, mix, seed, pool, qtok, tokens, ids_out,
                         sparse_out, device)
    return checks


def _bm25_answers(cfg, tokens, qtok, pool_idx, pos, n_batches, q_n, device):
    """The sparse branch's answers as the control gives them: the
    branch's semantics with the weights rounded to bf16, for the pool's
    order and for the scores, and the scores summed in bf16."""
    sp = cfg["sparse"]
    bm = ref.BM25(tokens, sp["vocab"], sp["k1"], sp["b"], device)
    width = bm25_width(cfg)
    table = bm.postings(sp["max_postings_per_term"], "bf16")
    low_s, low_i = bm.pool_topk([qtok[pi] for pi in pool_idx], table,
                                sp["candidate_pool"], width, "bf16")
    out = [(torch.full((q_n, width), float("-inf")),
            torch.full((q_n, width), cfg["rows"], dtype=torch.int32))
           for _ in range(n_batches)]
    for row, (b, r) in enumerate(pos):
        live = low_i[row] < cfg["rows"]
        out[b][0][r] = torch.as_tensor(np.where(live, low_s[row], -np.inf))
        out[b][1][r] = torch.as_tensor(low_i[row]).to(torch.int32)
    return out
