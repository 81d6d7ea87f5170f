#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Environment: the card (`nvidia-smi` name and power limit), torch/CUDA.
2. Build: every kernel of `rag_application_tpu_torch/csrc/` from source
   (nvcc, sm_90a) into build/torch_kernels/.
3. Main-path tables: a 1,048,576 x 768 DenseIndex (bf16 + int8 planes,
   matryoshka dims (128, 256)) of spectrally decaying gaussian rows and
   a 1M-doc SparseIndex of zipfian token docs (vocab 50k, 24 tokens),
   both made from seeds, as bench.py makes its corpus.
4. Kernel vs plain, on the card: each kernel wrapper against its plain
   PyTorch version at main-path shapes (8 corpus blocks, the full
   8192-query batch) — the scan on all reduce paths with/without mask,
   strips 1/4, strip_outputs off/on, and a ragged tail; the BM25 match
   on the batch's real candidates. Then kernel, plain and library times
   at the full main-path shape, beside each kernel's bound.
5. Main path: FusedSearcher.search on batches of 8192 noisy corpus rows
   plus their token texts, with bench.py's funnel — 3 timed batches
   without the matryoshka cascade (the bench's serving setting), one
   with the cascade and rrf fusion, one with dbsf. Checks recall@10
   against an exact oracle on 128 queries (>= 0.95) and that every
   kernel of the path was launched.
6. Local generation (`[gen-*]`), TinyLlama-1.1B-Chat-v1.0 at its
   published widths with random bf16 weights from a seed, int8 weights
   and int8 KV cache, `attn_kernel=True`:
   `[gen-check]` the int8-KV decode-attention kernel against its plain
   version at four cache geometries (the main decode shape with fully
   masked leading blocks and a fully masked row, B 1 at S 256, S 288,
   KVH 8 / hd 128); `[gen-time]` its kernel, plain and library times
   beside its bytes bound; `[gen-main]` `generate` at batch 64, prompt
   896, 128 new tokens (prefill ms, decode ms/step, tokens/s, peak
   memory, the kernel's launch count against the loop's), 4 decode steps
   of the kernel path against the einsum path, a profiled decode step,
   and one `LocalLLM.chat` and one `stream` at B 1 whose texts must be
   equal.

Prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Exits non-zero on any failure, and
when CUDA is not available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N = 1 << 20           # corpus rows (= capacity, so the scan runs maskless)
DIM = 768
BATCH = 8192
BLOCK = 16384         # scan block rows (bench: full mode, <= 768-d)
Q_BLOCK = 1024
CHECK_BLOCKS = 8      # corpus blocks in the kernel-vs-plain checks
VOCAB, DOC_LEN = 50_000, 24
K = 10
N_EVAL = 128

# H100 SXM published peaks (NVIDIA data sheet, dense, no sparsity)
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
BF16_OPS_S = 0.989e15
F32_OPS_S = 67e12

# TinyLlama/TinyLlama-1.1B-Chat-v1.0 config.json (published widths), in
# the serving setting of docs/decoder.md: batch 64, prompt 896, 128 new
GEN_CFG = dict(vocab_size=32000, hidden=2048, num_layers=22, heads=32,
               kv_heads=4, mlp_dim=5632, max_len=1024, rope_theta=10000.0,
               eps=1e-5, dtype="bfloat16", kv_quant=True, attn_kernel=True)
GEN_B, GEN_T, GEN_NEW = 64, 896, 128
# one decode step's attention: (B, S, KVH, G, hd), S = 896 + 128
ATTN_MAIN = (GEN_B, GEN_T + GEN_NEW, 4, 8, 64)
# kernel vs einsum path, 4 decode steps, logits ~N(0, 1): both round to
# bf16 at different points over 22 layers
GEN_LOGIT_ATOL = 0.25
CHAT_PROMPT = 512     # tokens: a power of two, so chat and stream share
CHAT_NEW = 512        # one cache layout and S = 1024 (bitwise-equal paths)


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_tokens(rng, n, vocab=VOCAB, doc_len=DOC_LEN):
    """Zipfian bag-of-words docs, as a token-id matrix (bench.py's)."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab, size=(n, doc_len), p=probs)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_tables(dev):
    """The main path's dense and sparse indexes, from seeds."""
    import torch

    from rag_application_tpu_torch.config import IndexConfig, SparseConfig
    from rag_application_tpu_torch.index.dense import DenseIndex
    from rag_application_tpu_torch.index.sparse import SparseIndex

    t0 = time.perf_counter()
    dense = DenseIndex(IndexConfig(dim=DIM, matryoshka_dims=(128, 256),
                                   initial_capacity=N), device=dev)
    # capacity-mode twin of the first CHECK_BLOCKS blocks (packed_scaled)
    cap_rows = CHECK_BLOCKS * BLOCK
    cap = DenseIndex(IndexConfig(dim=DIM, matryoshka_dims=(128, 256),
                                 store_bf16=False,
                                 initial_capacity=cap_rows), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = torch.exp(-0.003 * torch.arange(DIM, dtype=torch.float32,
                                            device=dev))
    slab = 131072
    for s in range(0, N, slab):
        x = torch.randn((min(slab, N - s), DIM), generator=gen,
                        device=dev) * scale
        dense.insert(x)
        if s < cap_rows:
            cap.insert(x[:cap_rows - s])
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    assert dense.size == dense.capacity == N and dense.fully_live
    assert cap.size == cap_rows and cap.int8_recip is not None

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tokens = synth_tokens(rng, N)
    sparse = SparseIndex(SparseConfig(candidate_pool=16,
                                      max_postings_per_term=128), device=dev)
    sparse.analyzer.vocab = {f"w{t}": t for t in range(VOCAB)}
    sparse.add_pretokenized(tokens)
    sparse.rebuild()
    torch.cuda.synchronize()
    t_sparse = time.perf_counter() - t0
    return dense, cap, sparse, tokens, rng, t_dense, t_sparse


def make_queries(dense, tokens, rng, seed):
    """Noisy copies of corpus rows (bench.py's make_queries) + texts."""
    import torch

    dev = dense.device
    idx = rng.integers(0, N, size=BATCH)
    rows = dense.vecs[torch.from_numpy(idx).to(dev)].float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = rows + 0.05 * torch.randn(rows.shape, generator=gen, device=dev)
    texts = [" ".join(f"w{t}" for t in tokens[i]) for i in idx]
    return q, texts


def exact_top_ids(dense, q, k):
    """Brute-force exact top-k of bf16-rounded normalized queries over the
    bf16 plane, in full f32 products."""
    import torch

    from rag_application_tpu_torch.ops.topk import stable_topk
    from rag_application_tpu_torch.utils import full_f32_matmul

    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    qb = qn.to(torch.bfloat16).float()
    best_v = best_i = None
    with full_f32_matmul():
        for s in range(0, dense.size, 131072):
            sc = qb @ dense.vecs[s:s + 131072].float().T
            v, i = stable_topk(sc, k)
            i = i + s
            if best_v is not None:
                v = torch.cat([best_v, v], dim=-1)
                i = torch.cat([best_i, i], dim=-1)
                v, pos = stable_topk(v, k)
                i = torch.gather(i, -1, pos)
            best_v, best_i = v, i
    return best_i.cpu().numpy()


def check_scan(dense, cap, q):
    """Kernel vs plain for every reduce path at main-path shapes.
    Returns (max abs err over all cases, cases run)."""
    import torch

    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.quant import quantize_int8

    dev = dense.device
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q8 = quantize_int8(qn)
    qb = qn.to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    cases = []

    setups = [
        # (label, corpus, queries, inv, block)
        (f"int8 block {BLOCK}", dense.int8, q8, None, BLOCK),
        (f"int8 block {2 * BLOCK}", dense.int8, q8, None, 2 * BLOCK),
        ("capacity int8 + recip", cap.int8, q8, cap.int8_recip, BLOCK),
        ("bf16 prefix 128 + inv_norms", dense.vecs[:, :128], qb[:, :128],
         dense.inv_norms[:, 0].contiguous(), BLOCK),
    ]
    # f32 path: each side within d * 2^-24 of the exact dot of unit rows
    # scaled by the prefix norm, so the two within twice that
    f32_atol = 2 * 128 * 2.0 ** -24
    for label, corpus, qs, inv, block in setups:
        rows = min(corpus.shape[0], CHECK_BLOCKS * BLOCK)
        c = corpus[:rows]
        iv = inv[:rows] if inv is not None else None
        for masked in (False, True):
            mask = (torch.rand(rows, generator=gen, device=dev) > 0.2
                    if masked else None)
            for strips, so in ((1, False), (4, False), (4, True)):
                mode = ft.reduce_path(c.dtype == torch.int8, iv is not None,
                                      c.shape[1], block, strips, so)
                kw = dict(valid_n=None, block_rows=block, mode=mode,
                          strips=strips, strip_outputs=so)
                kv, ki = ft.scan_sheet(c, qs, iv, mask, **kw)
                pv, pi = ft.scan_sheet_plain(c, qs, iv, mask, **kw)
                torch.cuda.synchronize()
                err = (kv - pv).abs().max().item()
                worst = max(worst, err)
                mism = (ki != pi).sum().item()
                if c.dtype == torch.int8:
                    ok = torch.equal(kv.view(torch.int32),
                                     pv.view(torch.int32)) and mism == 0
                else:
                    ok = err <= f32_atol and near_ties_ok(
                        c, qs, iv, ki, pi, 2 * f32_atol)
                cases.append(f"{label} mask={masked} strips={strips} "
                             f"strip_outputs={so} path={mode}: max_abs_err "
                             f"{err:.3g} id_mismatches {mism}")
                log("  " + cases[-1])
                if not ok:
                    raise AssertionError(f"scan kernel != plain: {cases[-1]}")
    # shapes off the main path that the wrapper accepts: a query count
    # that is no multiple of the kernel's 64-query tile, and depths that
    # end inside a 64-byte shared-memory chunk
    for dtype, d, mode in ((torch.int8, 100, "packed"),
                           (torch.bfloat16, 72, "f32")):
        x = torch.randn((2 * 4096, d), generator=gen, device=dev)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        qs = x[:1037] + 0.05 * torch.randn((1037, d), generator=gen,
                                           device=dev)
        if dtype == torch.int8:
            c, qs, iv = quantize_int8(x), quantize_int8(qs), None
        else:
            c, qs, iv = x.to(dtype), qs.to(dtype), torch.rand(
                2 * 4096, generator=gen, device=dev) + 0.5
        mask = torch.rand(2 * 4096, generator=gen, device=dev) > 0.2
        kw = dict(valid_n=8000, block_rows=4096, mode=mode, strips=2,
                  strip_outputs=True)
        kv, ki = ft.scan_sheet(c, qs, iv, mask, **kw)
        pv, pi = ft.scan_sheet_plain(c, qs, iv, mask, **kw)
        err = (kv - pv).abs().max().item()
        worst = max(worst, err)
        ok = (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
              and torch.equal(ki, pi)) if dtype == torch.int8 else (
            err <= 2 * d * 2.0 ** -24 * 1.5
            and near_ties_ok(c, qs, iv, ki, pi, 4 * d * 2.0 ** -24 * 1.5))
        cases.append(f"{dtype} d={d} Q=1037 valid_n=8000 mask strips=2 "
                     f"strip_outputs=True path={mode}: max_abs_err {err:.3g}"
                     f" id_mismatches {(ki != pi).sum().item()}")
        log("  " + cases[-1])
        if not ok:
            raise AssertionError(f"scan kernel != plain: {cases[-1]}")
    # ragged tail: valid_n bound + padded rows (what fused_scan_topk does)
    rows = CHECK_BLOCKS * BLOCK - 1000
    c = torch.nn.functional.pad(dense.int8[:rows], (0, 0, 0, 1000))
    kw = dict(valid_n=rows, block_rows=BLOCK, mode="packed", strips=1,
              strip_outputs=False)
    kv, ki = ft.scan_sheet(c, q8, None, None, **kw)
    pv, pi = ft.scan_sheet_plain(c, q8, None, None, **kw)
    if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
            and torch.equal(ki, pi)):
        raise AssertionError("scan kernel != plain with valid_n")
    log(f"  int8 ragged tail valid_n={rows}: bit-equal")
    return worst, len(cases) + 1


def near_ties_ok(c, qs, inv, ki, pi, tol) -> bool:
    """Where kernel and plain chose different rows, both rows must score
    within ``tol`` of each other (exact f64 scores)."""
    import torch

    diff = (ki != pi).nonzero()
    if diff.numel() == 0:
        return True
    qd = qs.double()
    a = ki[diff[:, 0], diff[:, 1], diff[:, 2]].long()
    b = pi[diff[:, 0], diff[:, 1], diff[:, 2]].long()
    qrow = qd[diff[:, 1]]
    sa = (qrow * c[a].double()).sum(-1) * inv[a].double()
    sb = (qrow * c[b].double()).sum(-1) * inv[b].double()
    return bool(((sa - sb).abs() <= tol).all().item())


def check_bm25(sparse, texts):
    """Kernel vs plain on the batch's real stage-1 candidates.
    Returns (max abs err, (dt, dw, q_terms, q_valid))."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob

    q_rows, q_terms, q_valid = sparse.encode_queries(texts)
    dv = sparse.device_arrays()
    n_docs = dv["doc_packed"].shape[0] - 1
    cand = ob.bm25_candidates(dv["post_docs"], dv["post_weights"], n_docs,
                              q_rows, q_valid, sparse.cfg.candidate_pool)
    packed = dv["doc_packed"][cand.long()]
    l = packed.shape[-1] // 2
    args = (packed[..., :l], packed[..., l:].view(torch.float32), q_terms,
            q_valid)
    k_out = ob.bm25_match_scores(*args)
    p_out = ob.bm25_match_scores_plain(*args)
    torch.cuda.synchronize()
    err = (k_out - p_out).abs().max().item()
    hits = (p_out > 0).float().mean().item()
    log(f"  bm25 match {tuple(k_out.shape)}: max_abs_err {err:.3g}, "
        f"candidates with a hit {hits:.3f}")
    # both add the L slots in order: bit-equal
    if not torch.equal(k_out, p_out):
        raise AssertionError("bm25 match kernel != plain")
    # a pool that does not divide the kernel's 128-row blocks, random terms
    gen = torch.Generator(device=q_rows.device).manual_seed(3)
    dt = torch.randint(-1, 64, (1000, 24, 32), generator=gen,
                       device=q_rows.device, dtype=torch.int32)
    dw = torch.rand((1000, 24, 32), generator=gen, device=q_rows.device)
    qt = torch.randint(0, 64, (1000, 32), generator=gen,
                       device=q_rows.device, dtype=torch.int32)
    qv = torch.rand((1000, 32), generator=gen, device=q_rows.device) > 0.5
    if not torch.equal(ob.bm25_match_scores(dt, dw, qt, qv),
                       ob.bm25_match_scores_plain(dt, dw, qt, qv)):
        raise AssertionError("bm25 match kernel != plain at pool 24")
    log("  bm25 match (1000, 24) random terms: bit-equal")
    return err, args


def time_kernels(dense, q, bm25_args):
    """Kernel, plain and library ms at the full main-path shapes."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.quant import quantize_int8

    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q8 = quantize_int8(qn)
    kw = dict(valid_n=None, block_rows=BLOCK, mode="packed", strips=1,
              strip_outputs=False)
    scan_ms = cuda_ms(lambda: ft.scan_sheet(dense.int8, q8, None, None,
                                            **kw), reps=3)
    scan_plain_ms = cuda_ms(lambda: ft.scan_sheet_plain(
        dense.int8, q8, None, None, **kw), reps=1)
    # yardstick: the int8 product alone (cuBLASLt via torch._int_mm)
    scan_lib_ms = cuda_ms(lambda: torch._int_mm(q8, dense.int8.t()), reps=3)
    nb = N // BLOCK
    # the cascade's bf16 prefix-128 scan (general path), for the record
    qb = qn.to(torch.bfloat16)[:, :128]
    inv0 = dense.inv_norms[:, 0].contiguous()
    f32_ms = cuda_ms(lambda: ft.scan_sheet(
        dense.vecs[:, :128], qb, inv0, None, **{**kw, "mode": "f32"}),
        reps=3)
    f32_bound = max((N * 128 * 2 + N * 4 + nb * BATCH * 128 * 8)
                    / HBM_BYTES_S, 2.0 * BATCH * N * 128 / BF16_OPS_S) * 1e3
    log(f"  fused_scan bf16 prefix-128 path (cascade), full shape: kernel "
        f"{f32_ms:.3f} ms, bound {f32_bound:.3f} ms")
    scan_bytes = N * DIM + BATCH * DIM + nb * BATCH * 128 * 8
    scan_ops = 2.0 * BATCH * N * DIM
    scan_bound = max(scan_bytes / HBM_BYTES_S, scan_ops / INT8_OPS_S) * 1e3
    scan_by = ("operations" if scan_ops / INT8_OPS_S > scan_bytes
               / HBM_BYTES_S else "bytes")

    dt, dw, qt, qv = bm25_args
    m_ms = cuda_ms(lambda: ob.bm25_match_scores(dt, dw, qt, qv), reps=20)
    m_plain_ms = cuda_ms(lambda: ob.bm25_match_scores_plain(dt, dw, qt, qv),
                         reps=5)
    q_, pool, l = dt.shape
    t = qt.shape[1]
    m_bytes = q_ * pool * l * 8 + q_ * t * 5 + q_ * pool * 4
    m_ops = q_ * pool * l * (t + 1)
    m_bound = max(m_bytes / HBM_BYTES_S, m_ops / F32_OPS_S) * 1e3
    m_by = "bytes" if m_bytes / HBM_BYTES_S >= m_ops / F32_OPS_S \
        else "operations"
    log(f"  fused_scan full shape ({N}x{DIM} int8, {BATCH} queries): "
        f"kernel {scan_ms:.3f} ms, plain {scan_plain_ms:.3f} ms, "
        f"torch._int_mm {scan_lib_ms:.3f} ms, bound {scan_bound:.3f} ms")
    log(f"  bm25_match {tuple(dt.shape)}: kernel {m_ms:.4f} ms, plain "
        f"{m_plain_ms:.4f} ms, bound {m_bound:.4f} ms")
    return ((scan_ms, scan_plain_ms, scan_lib_ms, scan_bound, scan_by),
            (m_ms, m_plain_ms, None, m_bound, m_by))


def run_main_path(dense, sparse, tokens, rng):
    """The port's entry point on full batches; returns (batch ms list,
    recall@10, launch counts, mode lines)."""
    import torch

    from rag_application_tpu_torch.config import FunnelConfig
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.rrf import INVALID_ID
    from rag_application_tpu_torch.search.fused import FusedSearcher

    funnel = FunnelConfig(matryoshka_limits=(512, 256), dense_limit=24,
                          quantized_limit=32, sparse_limit=12,
                          final_limit=K)
    searcher = FusedSearcher(dense, sparse, funnel, scan_block_rows=BLOCK,
                             scan_approx_sheet=True, scan_q_block=Q_BLOCK)
    assert searcher._resolved_engine() == ("pallas", BLOCK)
    batches = [make_queries(dense, tokens, rng, 100 + i) for i in range(5)]
    plan = [("serving (no cascade)", False, "dense")] * 3 + [
        ("cascade + rrf", True, "rrf"), ("cascade + dbsf", True, "dbsf")]

    ft.scan_sheet.launches = 0
    ob.bm25_match_scores.launches = 0
    results, times, lines = [], [], []
    for (label, matryoshka, fusion), (q, texts) in zip(plan, batches):
        f = FunnelConfig(**{**funnel.__dict__, "final_fusion": fusion})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        scores, ids = searcher.search(q, texts, K, use_matryoshka=matryoshka,
                                      funnel=f)
        ev1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = ev0.elapsed_time(ev1)
        results.append((q, scores, ids))
        times.append((label, dev_ms, host_ms))
        lines.append(f"  {label} [{fusion}]: {dev_ms:.2f} ms/batch (CUDA "
                     f"events), {host_ms:.2f} ms host, path "
                     f"{ft.fused_scan_topk.last_path}")
        log(lines[-1])
    launches = {"fused_scan": ft.scan_sheet.launches,
                "bm25_match": ob.bm25_match_scores.launches}
    profile_batch(searcher, *batches[0], funnel)

    for q, scores, ids in results:
        s, i = scores.cpu().numpy(), ids.cpu().numpy()
        assert s.shape == i.shape == (BATCH, K) and s.dtype == np.float32
        assert i.dtype == np.int32
        assert np.isfinite(s).all() and (i != INVALID_ID).all()
        assert ((0 <= i) & (i < N)).all()
    q0, _, ids0 = results[0]
    exact = exact_top_ids(dense, q0[:N_EVAL], K)
    got = ids0.cpu().numpy()[:N_EVAL]
    recall = float(np.mean([np.isin(exact[r], got[r]).mean()
                            for r in range(N_EVAL)]))
    return times, recall, launches


def profile_batch(searcher, q, texts, funnel):
    """One more serving batch under torch.profiler: device time by kernel
    and the device's busy share of the batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev0.record()
        t0 = time.perf_counter()
        prepared = searcher.prepare(q, texts)  # host: BM25 query encode
        t_prep = (time.perf_counter() - t0) * 1e3
        searcher.search_prepared(prepared, K, use_matryoshka=False,
                                 funnel=funnel)
        ev1.record()
        torch.cuda.synchronize()
    wall = ev0.elapsed_time(ev1)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] serving batch: {wall:.2f} ms wall (CUDA events), of it "
        f"prepare (host query encode, {type(searcher.sparse.analyzer).__name__})"
        f" {t_prep:.2f} ms; device busy {busy:.2f} ms ({busy / wall:.1%}), "
        f"idle {1 - busy / wall:.1%}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<4d} "
            f"{e.key[:96]}")


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def attn_inputs(dev, B, S, KVH, G, hd, seed, masked_rows=False):
    """Random rope'd queries, an int8 K/V cache made by the decoder's own
    quantizer, and a visibility mask (with fully masked leading blocks
    and one fully masked row when asked)."""
    import torch

    from rag_application_tpu_torch.models.decoder import _kv_quantize

    gen = torch.Generator(device=dev).manual_seed(seed)
    qg = torch.randn((B, 1, KVH, G, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    ck = _kv_quantize(torch.randn((B, S, KVH, hd), generator=gen, device=dev))
    cv = _kv_quantize(torch.randn((B, S, KVH, hd), generator=gen, device=dev))
    mask = torch.rand((B, S), generator=gen, device=dev) > 0.3
    if masked_rows:
        mask[: B // 4, : S // 2] = False   # fully masked leading blocks
        mask[B // 4] = False               # a row with no visible slot
    return qg, ck, cv, mask


def check_decode_attn(dev):
    """Kernel vs plain at four geometries; each case within 2 bf16 ulps
    of max|out| (the kernel rounds p*v_scale against its chunk's max, the
    plain version against the row's), fully masked rows exactly 0.
    Returns (worst max abs err, main-shape inputs)."""
    import torch

    from rag_application_tpu_torch.ops import decode_attn as da

    worst, main = 0.0, None
    cases = [("main decode shape, masked prefix + empty row", ATTN_MAIN,
              True), ("B 1, S 256", (1, 256, 4, 8, 64), False),
             ("S 288 (no multiple of 256)", (GEN_B, 288, 4, 8, 64), False),
             ("KVH 8, hd 128", (8, 1024, 8, 4, 128), True)]
    for i, (label, (B, S, KVH, G, hd), masked) in enumerate(cases):
        args = attn_inputs(dev, B, S, KVH, G, hd, 11 + i, masked)
        k_out = da.decode_attend_int8(*args)
        p_out = da.decode_attend_int8_plain(*args)
        torch.cuda.synchronize()
        err = (k_out.float() - p_out.float()).abs().max().item()
        bound = 2 * bf16_ulp(p_out.float().abs().max().item())
        empty = ~args[3].any(dim=1)
        zero = bool((k_out[empty] == 0).all().item())
        log(f"  decode_attn {label} (B {B}, S {S}, KVH {KVH}, G {G}, hd "
            f"{hd}): max_abs_err {err:.3g} (bound {bound:.3g}), "
            f"{int(empty.sum())} empty rows exactly 0: {zero}")
        if err > bound or not zero:
            raise AssertionError(f"decode_attn kernel != plain: {label}")
        worst = max(worst, err)
        if i == 0:
            main = args
    return worst, main


def time_decode_attn(args):
    """Kernel, plain and library ms at the main decode shape, and the
    bytes bound."""
    import torch
    import torch.nn.functional as F

    from rag_application_tpu_torch.ops import decode_attn as da

    qg, ck, cv, mask = args
    B, _, KVH, G, hd = qg.shape
    S = ck["q"].shape[1]
    ms = cuda_ms(lambda: da.decode_attend_int8(*args), reps=50)
    plain_ms = cuda_ms(lambda: da.decode_attend_int8_plain(*args), reps=5)

    # yardstick: SDPA on K/V dequantized to bf16 beforehand (timed apart)
    def deq(c):
        return (c["q"].float() * c["s"][..., None]).to(
            torch.bfloat16).transpose(1, 2)          # (B, KVH, S, hd)

    deq_ms = cuda_ms(lambda: (deq(ck), deq(cv)), reps=5)
    k, v = deq(ck), deq(cv)
    q = qg.reshape(B, KVH * G, 1, hd)
    am = mask[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, enable_gqa=True), reps=50)
    nbytes = (2 * ck["q"].numel() + 2 * ck["s"].numel() * 4 + mask.numel()
              + 2 * qg.numel() * 2)
    ops = 2 * 2 * B * KVH * G * S * hd
    bound = max(nbytes / HBM_BYTES_S, ops / BF16_OPS_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_S >= ops / BF16_OPS_S else "operations"
    log(f"  decode_attn {tuple(ck['q'].shape)}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA (bf16 K/V, enable_gqa) {lib_ms:.4f} ms + "
        f"dequantization {deq_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{nbytes / 1e6:.1f} MB)")
    return ms, plain_ms, lib_ms, bound, by


def run_generate(dev):
    """`generate` at the TinyLlama-1.1B serving shape; returns (params,
    cfg, decode_attn launches)."""
    import torch

    from rag_application_tpu_torch.models import decoder as dec
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import decode_attn as da
    from rag_application_tpu_torch.ops import fused_topk as ft

    cfg = dec.DecoderConfig(**GEN_CFG)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = dec.quantize_decoder_params(
        dec.init_decoder_params(gen, cfg, dev))
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for v in params.values()
                 for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"  weights: random bf16 from seed 0, int8-quantized in "
        f"{time.perf_counter() - t0:.1f} s; {wbytes / 1e9:.3f} GB on device")
    ids = torch.randint(0, cfg.vocab_size, (GEN_B, GEN_T), generator=gen,
                        device=dev, dtype=torch.int32)
    plen = torch.full((GEN_B,), GEN_T, dtype=torch.int32, device=dev)
    eos = cfg.vocab_size  # unreachable: no early stop

    dec.generate(params, cfg, ids[:, :64], plen // 14, 2, eos, 0)  # warm-up
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    ck, cv = dec.init_kv_cache(cfg, GEN_B, GEN_T + GEN_NEW, device=dev)
    logits, ck, cv = dec.prefill(params, cfg, ids, plen, ck, cv)
    ev[1].record()
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    del ck, cv, logits

    torch.cuda.reset_peak_memory_stats()
    ft.scan_sheet.launches = 0
    ob.bm25_match_scores.launches = 0
    da.decode_attend_int8.launches = 0
    t0 = time.perf_counter()
    ev[2].record()
    out, n = dec.generate(params, cfg, ids, plen, GEN_NEW, eos, 0)
    ev[3].record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = da.decode_attend_int8.launches
    gen_ms = ev[2].elapsed_time(ev[3])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = (gen_ms - prefill_ms) / GEN_NEW
    log(f"  generate B {GEN_B} x prompt {GEN_T} + {GEN_NEW} new: "
        f"{gen_ms:.1f} ms (CUDA events; host {host_s * 1e3:.1f} ms) -> "
        f"{GEN_B * GEN_NEW / (gen_ms / 1e3):,.0f} new tokens/s; prefill "
        f"alone {prefill_ms:.1f} ms ({GEN_B * GEN_T / (prefill_ms / 1e3):,.0f}"
        f" prompt tokens/s); decode {step_ms:.3f} ms/step; peak device "
        f"memory {peak:.2f} GiB")
    o = out.cpu().numpy()
    assert o.shape == (GEN_B, GEN_NEW) and ((0 <= o) & (o < cfg.vocab_size)
                                            ).all()
    assert (n.cpu().numpy() == GEN_NEW).all()
    want = cfg.num_layers * GEN_NEW  # one launch per layer per decode step
    log(f"  decode_attn launches in generate: {launches} (the loop implies "
        f"{cfg.num_layers} layers x {GEN_NEW} steps = {want}); fused_scan "
        f"{ft.scan_sheet.launches}, bm25_match "
        f"{ob.bm25_match_scores.launches}")
    if launches != want:
        raise AssertionError(f"decode_attn launched {launches} times, "
                             f"expected {want}")
    return params, cfg, ids, launches


def compare_attention_paths(params, cfg, ids):
    """4 decode steps on one prefilled cache through the kernel path and
    the einsum path, fed the same tokens; then one profiled step."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rag_application_tpu_torch.models import decoder as dec

    dev = ids.device
    cfg_e = dataclasses.replace(cfg, attn_kernel=False)
    plen = torch.full((GEN_B,), GEN_T, dtype=torch.int32, device=dev)
    ck, cv = dec.init_kv_cache(cfg, GEN_B, GEN_T + GEN_NEW, device=dev)
    logits, ck, cv = dec.prefill(params, cfg, ids, plen, ck, cv)
    ek = {k: t.clone() for k, t in ck.items()}
    evv = {k: t.clone() for k, t in cv.items()}
    tok = torch.argmax(logits, -1).to(torch.int32)
    worst, agree = 0.0, []
    for step in range(4):
        pos = plen + step
        lk, ck, cv = dec.decode_step(params, cfg, tok, pos, GEN_T + step,
                                     ck, cv)
        le, ek, evv = dec.decode_step(params, cfg_e, tok, pos, GEN_T + step,
                                      ek, evv)
        worst = max(worst, (lk - le).abs().max().item())
        agree.append((lk.argmax(-1) == le.argmax(-1)).float().mean().item())
        tok = torch.argmax(lk, -1).to(torch.int32)
    log(f"  kernel path vs einsum path, 4 decode steps: max abs logit err "
        f"{worst:.4f} (tolerance {GEN_LOGIT_ATOL}; max|logit| "
        f"{lk.abs().max().item():.2f}), greedy agreement per step {agree}")
    if not worst <= GEN_LOGIT_ATOL:
        raise AssertionError("kernel path logits differ from einsum path")

    pos = plen + 4
    dec.decode_step(params, cfg, tok, pos, GEN_T + 4, ck, cv)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev0.record()
        for step in range(5, 9):
            dec.decode_step(params, cfg, tok, plen + step, GEN_T + step,
                            ck, cv)
        ev1.record()
        torch.cuda.synchronize()
    wall = ev0.elapsed_time(ev1) / 4
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / 4
    attn = sum(e.self_device_time_total for e in kern
               if "decode_attn" in e.key) / 1e3 / 4
    log(f"[profile] decode step (B {GEN_B}, S {GEN_T + GEN_NEW}), mean of 4: "
        f"{wall:.3f} ms wall (CUDA events); device busy {busy:.3f} ms "
        f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; decode_attn "
        f"kernels {attn:.3f} ms ({attn / wall:.1%} of the step)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 4e3:10.3f} ms/step  "
            f"x{e.count // 4:<4d} {e.key[:90]}")
    return worst


def run_local_llm(params, cfg, dev):
    """One LocalLLM.chat and one stream at B 1, greedy; texts equal."""
    import asyncio

    import torch

    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage
    from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer
    from rag_application_tpu_torch.ops import decode_attn as da

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ":", "user", "assistant"]
    words += [f"w{i}" if i % 2 else f"##p{i}"
              for i in range(cfg.vocab_size - len(words))]
    tok = WordPieceTokenizer.from_vocab_list(words, max_len=cfg.max_len)
    llm = LocalLLM(params, cfg, tok, device=dev)
    # [CLS] user : w.. assistant : = CHAT_PROMPT tokens (trailing [SEP]
    # dropped): bucket == prompt, so chat's cache layout is stream's
    content = " ".join(f"w{2 * i + 1}" for i in range(CHAT_PROMPT - 5))
    msgs = [ChatMessage("user", content)]
    assert len(llm.render(msgs)) == CHAT_PROMPT

    async def drive():
        t0 = time.perf_counter()
        resp = await llm.chat(msgs, max_tokens=CHAT_NEW, temperature=0.0)
        t1 = time.perf_counter()
        chunks = [c async for c in llm.stream(msgs, max_tokens=CHAT_NEW,
                                              temperature=0.0)]
        return resp, chunks, t1 - t0, time.perf_counter() - t1

    da.decode_attend_int8.launches = 0
    resp, chunks, chat_s, stream_s = asyncio.run(drive())
    torch.cuda.synchronize()
    text = "".join(chunks)
    log(f"  LocalLLM.chat: {resp.usage}, {chat_s:.2f} s; stream: "
        f"{len(chunks)} chunks, {stream_s:.2f} s; decode_attn launches "
        f"{da.decode_attend_int8.launches}; text[:80] {resp.content[:80]!r}")
    if not resp.content or text != resp.content:
        raise AssertionError("chat and stream texts differ or are empty")
    return da.decode_attend_int8.launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    from rag_application_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    kb.build(force=True)
    kb.load()
    t_build = time.perf_counter() - t0
    log(f"[build] {len(kb.sources())} kernel sources -> {kb.LIB} in "
        f"{t_build:.1f} s")
    with open(f"{kb.BUILD_DIR}/build.log") as f:
        for line in f:
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.rstrip())

    dense, cap, sparse, tokens, rng, t_dense, t_sparse = build_tables(dev)
    log(f"[tables] dense {N}x{DIM} built in {t_dense:.1f} s, sparse {N} "
        f"docs in {t_sparse:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    log("[check] kernel vs plain on the card")
    q, texts = make_queries(dense, tokens, rng, 1)
    t0 = time.perf_counter()
    scan_err, n_cases = check_scan(dense, cap, q)
    bm25_err, bm25_args = check_bm25(sparse, texts)
    log(f"[check] {n_cases} scan cases + bm25 passed in "
        f"{time.perf_counter() - t0:.1f} s")
    del cap

    log(f"[time] kernels at the main-path shapes ({card})")
    scan_t, bm25_t = time_kernels(dense, q, bm25_args)
    torch.cuda.empty_cache()

    log(f"[main] FusedSearcher.search, batch {BATCH}, block {BLOCK}, "
        f"q_block {Q_BLOCK} ({card})")
    times, recall, launches = run_main_path(dense, sparse, tokens, rng)
    serving = [t[1] for t in times if t[0].startswith("serving")]
    log(f"[main] serving ms/batch {serving} (mean "
        f"{sum(serving) / len(serving):.2f}), recall@10 vs exact on "
        f"{N_EVAL} queries {recall:.4f}, launches {launches}")
    if recall < 0.95:
        raise AssertionError(f"recall@10 {recall:.4f} < 0.95")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    del dense, sparse, tokens, q, texts, bm25_args
    torch.cuda.empty_cache()

    log("[gen-check] decode_attn kernel vs plain on the card")
    attn_err, attn_args = check_decode_attn(dev)
    log(f"[gen-time] decode_attn at the main decode shape ({card})")
    attn_t = time_decode_attn(attn_args)
    del attn_args
    torch.cuda.empty_cache()
    log(f"[gen-main] generate, TinyLlama-1.1B widths, {GEN_B} x {GEN_T} + "
        f"{GEN_NEW}, int8 weights + int8 KV, attn_kernel ({card})")
    params, gcfg, gen_ids, attn_launches = run_generate(dev)
    compare_attention_paths(params, gcfg, gen_ids)
    torch.cuda.empty_cache()
    run_local_llm(params, gcfg, dev)

    def entry(name, source, replaces, launches_, err, t):
        ms, plain_ms, lib_ms, bound_ms, bound_by = t
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    print(json.dumps({"kernels": [
        entry("fused_scan", "rag_application_tpu_torch/csrc/fused_scan.cu",
              "rag_application_tpu/ops/fused_topk.py:61",
              launches["fused_scan"], scan_err, scan_t),
        entry("bm25_match", "rag_application_tpu_torch/csrc/bm25_match.cu",
              "rag_application_tpu/ops/bm25.py:45",
              launches["bm25_match"], bm25_err, bm25_t),
        entry("decode_attn", "rag_application_tpu_torch/csrc/decode_attn.cu",
              "rag_application_tpu/ops/decode_attn.py:86", attn_launches,
              attn_err, attn_t),
    ]}), flush=True)
    log(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
