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
   strips 1/4, strip_outputs off/on, ragged tails, and off-path shapes
   (int8 d 100 to 2720 and bf16 d 72 to 2176 at both query-tile sizes,
   sliced tables, Q 1037; an f32 corpus and odd-d / odd-stride bf16 on
   the CUDA-core kernel), each case asserting the kernel it took; the
   BM25 match, read by candidate id (`bm25_match_rows`), bit-equal on the
   batch's real candidates, rows of sentinels only, pool 24, T 5 with
   invalid slots and L 8, and on gathered rows (`bm25_match_scores`).
   Then kernel, plain and library times at the full main-path shapes,
   beside each kernel's bound: the int8 scan and the cascade's bf16
   prefix scan, each also at the tokens wire's shape, the CUDA-core
   kernel at the cascade's shape and on an f32 corpus, and BM25's stage
   2 before (the gather of the rows alone) and after.
5. Main path: FusedSearcher.search on batches of 8192 noisy corpus rows
   plus their token texts, with bench.py's funnel — 3 timed batches
   without the matryoshka cascade (the bench's serving setting), one
   with the cascade and rrf fusion, one with dbsf. Checks recall@10
   against an exact oracle on 128 queries (>= 0.95) and that every
   kernel of the path was launched, BM25's through `bm25_match_rows`
   only; one more cascade batch has each of its scan and BM25 launches
   held against the plain version, the bf16 one on the bf16 tensor-core
   kernel, and its `bm25_topk` run again under a dispatch mode that
   fails on any op copying rows of the doc-major table.
6. The write path and the tokens wire, at the repo's defaults
   (`Config()`: a 768-d index with bf16 + int8 planes and matryoshka dims
   (64, 128, 256); `EncoderConfig()`: vocab 30528, hidden 384, 6 layers,
   12 heads, MLP 1536, out 768, bf16, random weights from seed 0;
   Embedder windows of 128 tokens in batches of 64):
   `[prep-check]` the insert prep kernel bit-equal to its plain version
   at six shapes (a 131,072 x 768 slab, a 64-row document, one row,
   1037 x 100, dims=(), zero and rescaled rows), and in place
   (`prepare_vectors_into`) at three row offsets of index-shaped planes
   whose guard rows must stay untouched; `[prep-time]` its kernel (in
   place and into new tensors) and plain times beside its bytes bound;
   `[ingest]` 4,096 documents x 64 chunks (24-word zipf texts) through
   `Embedder.encode` and `Collection.store_document_vectors` (chunks/s,
   encode and store ms per document, a profiled document's device busy
   share, one in-place prep launch per document), then one document's
   `DenseIndex.insert` under the profiler, which must be the upload and
   one prep launch; `[tokens]` 8 batches of 256
   noisy chunk texts through `hybrid_search_text_batch`, held to
   encode-then-`hybrid_search_batch` (equal rows but at near-ties) and to
   recall@10 >= 0.95 against an exact oracle, then `delete_document` and
   a batch in which no hit may come from the deleted document. In one
   batch before the delete and one after it, every scan and BM25 launch
   of the path (the cascade's bf16 prefix-64 scan, the int8 scan, the
   match at the collection's pool; masked after the delete) is held
   against its plain version on the same inputs.
7. Local generation (`[gen-*]`), TinyLlama-1.1B-Chat-v1.0 at its
   published widths with random bf16 weights from a seed, int8 weights
   and int8 KV cache, `attn_kernel=True`:
   `[gen-check]` the int8-KV decode-attention kernel against its plain
   version at nine cache geometries (the main decode shape with fully
   masked leading blocks and a fully masked row, B 1 at S 256 and at the
   chat's S 1024, S 288, KVH 8 / hd 128, G 7 and G 16, and K/V bytes
   running through -128..127, once more with one visible slot a row,
   which must match bit for bit); `[gen-time]` its kernel (on a cache
   that stays in L2 and on caches read cold), plain and library times
   beside its bytes bound, at the main decode shape and the chat's B 1;
   `[gen-main]` `generate` at batch 64, prompt
   896, 128 new tokens (prefill ms, decode ms/step, tokens/s, peak
   memory, the kernel's launch count against the loop's), 4 decode steps
   of the kernel path against the einsum path, a profiled decode step,
   and one `LocalLLM.chat` and one `stream` at B 1 whose texts must be
   equal.

Prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Exits non-zero on any failure, and
when CUDA is not available.

    python3 chip_smoke.py --scan

runs steps 1-2, the dense tables of step 3 and the scan's part of step 4
alone (its checks and its times), for kernel work on the scan.

    python3 chip_smoke.py --attn

runs steps 1-2 and then `[gen-check]` and `[gen-time]` of step 7 alone,
for kernel work on the decode attention.

    python3 chip_smoke.py --match-prep

runs steps 1-2, `[prep-check]` and `[prep-time]` of step 6, then the
sparse table of step 3 and the BM25 match's checks and stage-2 times of
step 4 alone, for kernel work on either kernel.
"""

from __future__ import annotations

import contextlib
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

# the write path: Config()/EncoderConfig() defaults, Embedder(max_len=128,
# batch_size=64) as the README's quick start builds it
PREP_SLAB = 131072    # rows per insert slab (build_tables inserts 8 + 1)
PREP_DIMS = (64, 128, 256)  # IndexConfig().matryoshka_dims
INGEST_DOCS, INGEST_CHUNKS = 4096, 64
EMB_LEN, EMB_BATCH = 128, 64
TOK_BATCHES, TOK_BATCH = 8, 256  # the API micro-batcher's default batch
TOK_FLIP = 0.2        # share of a query's words resampled (bench.py)


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


def reset_scan_counts(ft) -> None:
    """Set the scan wrapper's launch counts (total and by kernel) to 0."""
    ft.scan_sheet.launches = 0
    for route in ft.route_launches:
        ft.route_launches[route] = 0


def scan_counts(ft) -> dict:
    """The scan wrapper's launches by entry of the `kernels` line: the
    bf16 tensor-core kernel on its own; `fused_scan` is the int8 kernel
    and the CUDA-core kernel, both behind `csrc/fused_scan.cu`'s entry."""
    by = ft.route_launches
    if sum(by.values()) != ft.scan_sheet.launches:
        raise AssertionError(f"scan launches by kernel {by} do not add up to "
                             f"{ft.scan_sheet.launches}")
    return {"fused_scan": by["fused_scan_int8"] + by["fused_scan"],
            "fused_scan_bf16": by["fused_scan_bf16"]}


def rose(counts, before) -> list:
    """The keys of ``counts`` that differ from the snapshot ``before``."""
    return [k for k, v in counts.items() if v != before[k]]


def build_tables(dev):
    """The main path's dense and sparse indexes, from seeds."""
    dense, cap, t_dense = build_dense(dev)
    sparse, tokens, rng, t_sparse = build_sparse(dev)
    return dense, cap, sparse, tokens, rng, t_dense, t_sparse


def build_sparse(dev):
    """The main path's sparse index, from a seed; returns (sparse, tokens,
    rng, seconds)."""
    import torch

    from rag_application_tpu_torch.config import SparseConfig
    from rag_application_tpu_torch.index.sparse import SparseIndex

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tokens = synth_tokens(rng, N)
    sparse = SparseIndex(SparseConfig(candidate_pool=16,
                                      max_postings_per_term=128), device=dev)
    sparse.analyzer.vocab = {f"w{t}": t for t in range(VOCAB)}
    sparse.add_pretokenized(tokens)
    sparse.rebuild()
    torch.cuda.synchronize()
    return sparse, tokens, rng, time.perf_counter() - t0


def build_dense(dev):
    """The main path's dense index and its capacity-mode twin of the first
    CHECK_BLOCKS blocks, from a seed; returns (dense, cap, seconds)."""
    import torch

    from rag_application_tpu_torch.config import IndexConfig
    from rag_application_tpu_torch.index.dense import DenseIndex

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
    return dense, cap, t_dense


def make_queries(dense, tokens, rng, seed):
    """Noisy copies of corpus rows (bench.py's make_queries) + their texts
    (None without ``tokens``)."""
    import torch

    dev = dense.device
    idx = rng.integers(0, N, size=BATCH)
    rows = dense.vecs[torch.from_numpy(idx).to(dev)].float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = rows + 0.05 * torch.randn(rows.shape, generator=gen, device=dev)
    texts = None if tokens is None else [
        " ".join(f"w{t}" for t in tokens[i]) for i in idx]
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
    """Kernel vs plain for every reduce path at main-path shapes, each
    case asserting the kernel `scan_sheet` took. Returns (max abs err by
    kernel, cases run)."""
    import torch

    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.quant import quantize_int8

    dev = dense.device
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q8 = quantize_int8(qn)
    qb = qn.to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = dict.fromkeys(ft.ROUTES, 0.0)
    cases = []

    def both(want, c, qs, iv, mask, **kw):
        """(kernel sheet, plain sheet, max abs err); the kernel's launch
        must be on the route ``want``."""
        before = dict(ft.route_launches)
        kv, ki = ft.scan_sheet(c, qs, iv, mask, **kw)
        took = rose(ft.route_launches, before)
        if took != [want]:
            raise AssertionError(f"scan took {took}, expected {want}: "
                                 f"{c.dtype} x {qs.dtype}, d {c.shape[1]}")
        pv, pi = ft.scan_sheet_plain(c, qs, iv, mask, **kw)
        torch.cuda.synchronize()
        err = (kv - pv).abs().max().item()
        worst[want] = max(worst[want], err)
        return kv, ki, pv, pi, err

    setups = [
        # (label, corpus, queries, inv, block)
        (f"int8 block {BLOCK}", dense.int8, q8, None, BLOCK),
        (f"int8 block {2 * BLOCK}", dense.int8, q8, None, 2 * BLOCK),
        ("capacity int8 + recip", cap.int8, q8, cap.int8_recip, BLOCK),
        ("bf16 prefix 128 + inv_norms", dense.vecs[:, :128], qb[:, :128],
         dense.inv_norms[:, 0].contiguous(), BLOCK),
    ]
    # f32 path: bf16 x bf16 products are exact in f32, so kernel and plain
    # differ only in the order of the f32 sums. Each side is within
    # d * 2^-24 of the exact dot of unit rows scaled by the prefix norm
    # (one rounding of 2^-24 per term added; the tensor core adds 16 exact
    # products per accumulation step, so even a truncating step of 2^-23
    # leaves its side at (d / 16) * 2^-23 < d * 2^-24), the two within
    # twice that
    f32_atol = 2 * 128 * 2.0 ** -24
    for label, corpus, qs, inv, block in setups:
        rows = min(corpus.shape[0], CHECK_BLOCKS * BLOCK)
        c = corpus[:rows]
        iv = inv[:rows] if inv is not None else None
        want = "fused_scan_int8" if c.dtype == torch.int8 \
            else "fused_scan_bf16"
        for masked in (False, True):
            mask = (torch.rand(rows, generator=gen, device=dev) > 0.2
                    if masked else None)
            for strips, so in ((1, False), (4, False), (4, True)):
                mode = ft.reduce_path(c.dtype == torch.int8, iv is not None,
                                      c.shape[1], block, strips, so)
                kv, ki, pv, pi, err = both(
                    want, c, qs, iv, mask, valid_n=None, block_rows=block,
                    mode=mode, strips=strips, strip_outputs=so)
                mism = (ki != pi).sum().item()
                if c.dtype == torch.int8:
                    ok = torch.equal(kv.view(torch.int32),
                                     pv.view(torch.int32)) and mism == 0
                else:
                    ok = err <= f32_atol and near_ties_ok(
                        c, qs, iv, ki, pi, 2 * f32_atol)
                cases.append(f"{label} mask={masked} strips={strips} "
                             f"strip_outputs={so} path={mode} [{want}]: "
                             f"max_abs_err {err:.3g} id_mismatches {mism}")
                log("  " + cases[-1])
                if not ok:
                    raise AssertionError(f"scan kernel != plain: {cases[-1]}")
    # shapes off the main path that the wrapper accepts, at Q 1037 (no
    # multiple of the kernels' query tiles of 32, 64 and 128), valid_n
    # inside the last block, a mask, and 2 strips with their own bins.
    # int8: depths that end inside a staged chunk (d % 16 != 0 takes the
    # 4-byte copies), corpora sliced from wider tables (row stride > d),
    # depths past the resident query tile (d > 1024 at 128 queries, > 2048
    # at 64), whose query chunks ride in the ring. bf16 x bf16: d 72 ends
    # inside a chunk, d 100 of a 116-wide table takes the 4-byte copies,
    # both on 8 blocks (128-query tiles, row groups in shared memory); d 72
    # and a 128-wide slice of a 768-wide table on 4 blocks and on 2 (too
    # few thread blocks for the card at 128 queries a tile, then at 64: 64-
    # and 32-query tiles with the A fragments in registers); d 256 and 768
    # are 2 and 6 chunks a row group against the resident query tile, d
    # 1280 (64-query tiles) and 2176 (32-query tiles) are past it. An f32
    # corpus, and bf16 with an odd d or an odd row stride, which cp.async
    # cannot copy, hold the CUDA-core kernel.
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for dtype, d, width, mode, blocks in (
            (i8, 100, 100, "packed", 2),
            (i8, 100, 116, "packed_scaled", 2),
            (i8, 100, 116, "int8_general", 2),
            (i8, 2048, 2064, "packed", 2),
            (i8, 2052, 2068, "packed_scaled", 2),
            (i8, 2720, 2736, "int8_general", 2),
            (bf, 72, 72, "f32", 8),
            (bf, 100, 116, "f32", 8),
            (bf, 256, 272, "f32", 8),
            (bf, 768, 768, "f32", 8),
            (bf, 1280, 1296, "f32", 8),
            (bf, 72, 72, "f32", 4),
            (bf, 128, 768, "f32", 4),
            (bf, 72, 72, "f32", 2),
            (bf, 128, 768, "f32", 2),
            (bf, 2176, 2192, "f32", 2),
            (f32, 100, 116, "f32", 2),
            (bf, 101, 101, "f32", 2),
            (bf, 100, 117, "f32", 2)):
        n = blocks * 4096
        x = torch.randn((n, width), generator=gen, device=dev)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        qs = x[:1037, :d] + 0.05 * torch.randn((1037, d), generator=gen,
                                               device=dev)
        if dtype == i8:
            c, qs = quantize_int8(x)[:, :d], quantize_int8(qs)
            iv = torch.rand(n, generator=gen, device=dev) + 0.5 \
                if mode == "packed_scaled" else None
            want = "fused_scan_int8"
        else:
            qs = qs / torch.linalg.vector_norm(qs, dim=-1, keepdim=True)
            c, qs = x.to(dtype)[:, :d], qs.to(dtype)
            iv = torch.rand(n, generator=gen, device=dev) + 0.5
            want = "fused_scan_bf16" if dtype == bf and d % 2 == 0 \
                and width % 2 == 0 else "fused_scan"
        mask = torch.rand(n, generator=gen, device=dev) > 0.2
        kv, ki, pv, pi, err = both(
            want, c, qs, iv, mask, valid_n=n - 192, block_rows=4096,
            mode=mode, strips=2, strip_outputs=True)
        # unit rows, inv in [0.5, 1.5): the f32 bound above, scaled by 1.5
        ok = (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
              and torch.equal(ki, pi)) if dtype == i8 else (
            err <= 2 * d * 2.0 ** -24 * 1.5
            and near_ties_ok(c, qs, iv, ki, pi, 4 * d * 2.0 ** -24 * 1.5))
        cases.append(f"{dtype} d={d} ld={c.stride(0)} rows={n} Q=1037 "
                     f"valid_n={n - 192} mask strips=2 strip_outputs=True "
                     f"path={mode} [{want}]: max_abs_err {err:.3g} "
                     f"id_mismatches {(ki != pi).sum().item()}")
        log("  " + cases[-1])
        if not ok:
            raise AssertionError(f"scan kernel != plain: {cases[-1]}")
    # ragged tail: valid_n bound + padded rows (what fused_scan_topk does)
    rows = CHECK_BLOCKS * BLOCK - 1000
    kw = dict(valid_n=rows, block_rows=BLOCK, strips=1, strip_outputs=False)
    c = torch.nn.functional.pad(dense.int8[:rows], (0, 0, 0, 1000))
    kv, ki, pv, pi, _ = both("fused_scan_int8", c, q8, None, None,
                             mode="packed", **kw)
    if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
            and torch.equal(ki, pi)):
        raise AssertionError("scan kernel != plain with valid_n")
    log(f"  int8 ragged tail valid_n={rows}: bit-equal")
    c = torch.nn.functional.pad(dense.vecs[:rows, :128], (0, 0, 0, 1000))
    iv = torch.nn.functional.pad(dense.inv_norms[:rows, 0], (0, 1000))
    kv, ki, pv, pi, err = both("fused_scan_bf16", c, qb[:, :128], iv, None,
                               mode="f32", **kw)
    if not (err <= f32_atol and ((ki < rows) | (kv <= ft.NEG)).all().item()
            and near_ties_ok(c, qb[:, :128], iv, ki, pi, 2 * f32_atol)):
        raise AssertionError("bf16 scan kernel != plain with valid_n")
    log(f"  bf16 ragged tail valid_n={rows}: max_abs_err {err:.3g} "
        f"id_mismatches {(ki != pi).sum().item()}")
    return worst, len(cases) + 2


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
    """Kernel vs plain: the fused entry `bm25_match_rows` bit-equal to
    `bm25_match_rows_plain` on the batch's real stage-1 candidates, on
    rows of sentinels only, at pool 24, at T 5 with invalid slots and at
    L 8; the gathered-rows entry `bm25_match_scores` bit-equal to its
    plain version on a random pool-24 case. Returns (max abs err,
    (doc_packed, cand, q_terms, q_valid) of the batch)."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob

    q_rows, q_terms, q_valid = sparse.encode_queries(texts)
    dv = sparse.device_arrays()
    doc_packed = dv["doc_packed"]
    n_docs = doc_packed.shape[0] - 1
    cand = ob.bm25_candidates(dv["post_docs"], dv["post_weights"], n_docs,
                              q_rows, q_valid, sparse.cfg.candidate_pool)
    dev = cand.device
    gen = torch.Generator(device=dev).manual_seed(3)

    def table(n, l):
        """(n + 1, 2l) packed rows, terms in [-1, 64), row n the sentinel."""
        terms = torch.randint(-1, 64, (n + 1, l), generator=gen, device=dev,
                              dtype=torch.int32)
        w = torch.rand((n + 1, l), generator=gen, device=dev)
        terms[n] = -1
        w[n] = 0.0
        return torch.cat([terms, w.view(torch.int32)], dim=1)

    def queries(q, t):
        qt = torch.randint(0, 64, (q, t), generator=gen, device=dev,
                           dtype=torch.int32)
        return qt, torch.rand((q, t), generator=gen, device=dev) > 0.5

    def ids(q, pool, n):
        return torch.randint(0, n + 1, (q, pool), generator=gen, device=dev,
                             dtype=torch.int32)

    t32, t8 = table(5000, 32), table(5000, 8)
    cases = [("main-path candidates", doc_packed, cand, q_terms, q_valid),
             ("rows all sentinel", doc_packed,
              torch.full_like(cand[:256], n_docs), q_terms[:256],
              q_valid[:256]),
             ("pool 24", t32, ids(1000, 24, 5000), *queries(1000, 32)),
             ("T 5 with invalid slots", t32, ids(1000, 16, 5000),
              *queries(1000, 5)),
             ("L 8", t8, ids(1000, 16, 5000), *queries(1000, 32))]
    worst = 0.0
    for label, tab, c, qt, qv in cases:
        k_out = ob.bm25_match_rows(tab, c, qt, qv)
        p_out = ob.bm25_match_rows_plain(tab, c, qt, qv)
        torch.cuda.synchronize()
        err = (k_out - p_out).abs().max().item()
        worst = max(worst, err)
        log(f"  bm25_match_rows, {label}: cand {tuple(c.shape)}, L "
            f"{tab.shape[1] // 2}, T {qt.shape[1]}: max_abs_err {err:.3g}, "
            f"candidates with a hit {(p_out > 0).float().mean().item():.3f}")
        # both add the L slots in order: bit-equal
        if not torch.equal(k_out, p_out):
            raise AssertionError(f"bm25 match kernel != plain: {label}")
    # the gathered-rows entry (the reference's contract), random terms
    dt = torch.randint(-1, 64, (1000, 24, 32), generator=gen, device=dev,
                       dtype=torch.int32)
    dw = torch.rand((1000, 24, 32), generator=gen, device=dev)
    qt, qv = queries(1000, 32)
    if not torch.equal(ob.bm25_match_scores(dt, dw, qt, qv),
                       ob.bm25_match_scores_plain(dt, dw, qt, qv)):
        raise AssertionError("bm25 match kernel != plain at pool 24 on "
                             "gathered rows")
    log("  bm25_match_scores (gathered rows) (1000, 24) random terms: "
        "bit-equal")
    return worst, (doc_packed, cand, q_terms, q_valid)


def check_no_gathered_copy(call):
    """Run one recorded `bm25_topk` call again under a dispatch mode that
    sees every tensor op: fail if any op other than a view reads the
    doc-major table (a gathered copy of its rows), if the call reaches
    the gathered-rows entry `bm25_match_scores`, or if it does not launch
    the fused kernel once. Returns the names of the ops that touched the
    table."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from rag_application_tpu_torch.ops import bm25 as ob

    args, kwargs, _, _ = call
    base = args[2].untyped_storage().data_ptr()

    def on_table(t):
        return isinstance(t, torch.Tensor) \
            and t.untyped_storage().data_ptr() == base

    touched, copies = [], []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if any(on_table(t) for t in tree_leaves((a, kw))):
                touched.append(str(func))
                if not all(on_table(t) for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor)):
                    copies.append(str(func))
            return out

    before = (ob.bm25_match_rows.launches, ob.bm25_match_scores.launches)
    with Watch():
        ob.bm25_topk(*args, **kwargs)
    torch.cuda.synchronize()
    rose = (ob.bm25_match_rows.launches - before[0],
            ob.bm25_match_scores.launches - before[1])
    if copies or rose != (1, 0):
        raise AssertionError(f"bm25_topk on the card: ops copying the "
                             f"table {copies}, launches (rows, gathered) "
                             f"{rose}")
    return touched


@contextlib.contextmanager
def recording(module, name, counts=None):
    """While the block runs, record ``(args, kwargs, result, took)`` of
    every call of the kernel wrapper ``module.name`` (the wrapper still
    runs); ``took`` lists the keys of ``counts``, the wrapper's launch
    counts by kernel, that rose during the call. The wrapper counts its
    launches on its module-level name, so these launches go to the
    recorder's own ``launches`` and the wrapper's count is left as it
    was."""
    fn = getattr(module, name)
    calls = []

    def rec(*args, **kwargs):
        before = dict(counts or {})
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out, rose(counts or {}, before)))
        return out

    rec.launches = 0
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def check_recorded(label, scans, matches):
    """Each recorded `scan_sheet` and `bm25_match_rows` launch of a path,
    against the plain version on the same inputs: int8 sheets bit-equal;
    f32 sheets within 2 d 2^-24 (each side within d 2^-24 of the exact
    dot of unit prefixes) with other ids only at near-ties; BM25
    bit-equal. Every int8 scan must have taken the int8 tensor-core
    kernel and every bf16 scan the bf16 one. Returns (max abs err of the
    int8 scans, of the bf16 scans, of the BM25 matches)."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft

    kinds = {args[0].dtype for args, _, _, _ in scans}
    if kinds != {torch.int8, torch.bfloat16} or not matches:
        raise AssertionError(f"{label}: recorded scans {kinds} and "
                             f"{len(matches)} bm25 matches")
    want = {torch.int8: "fused_scan_int8", torch.bfloat16: "fused_scan_bf16"}
    scan_err = dict.fromkeys(want, 0.0)
    for (c, qs, iv, mask), kw, (kv, ki), took in scans:
        if took != [want[c.dtype]]:
            raise AssertionError(f"{label}: a {c.dtype} x {qs.dtype} scan "
                                 f"took {took}, not {want[c.dtype]}")
        pv, pi = ft.scan_sheet_plain(c, qs, iv, mask, **kw)
        err = (kv - pv).abs().max().item()
        scan_err[c.dtype] = max(scan_err[c.dtype], err)
        mism = (ki != pi).sum().item()
        if c.dtype == torch.int8:
            ok = torch.equal(kv.view(torch.int32),
                             pv.view(torch.int32)) and mism == 0
        else:
            atol = 2 * c.shape[1] * 2.0 ** -24
            ok = err <= atol and near_ties_ok(c, qs, iv, ki, pi, 2 * atol)
        line = (f"{label}: scan {c.dtype} x {qs.dtype} {tuple(c.shape)} "
                f"[{took[0]}] Q {qs.shape[0]} "
                f"block {kw['block_rows']} path {kw['mode']} "
                f"inv_norms={iv is not None} mask={mask is not None}: "
                f"max_abs_err {err:.3g} id_mismatches {mism}")
        log("  " + line)
        if not ok:
            raise AssertionError(f"scan kernel != plain: {line}")
    bm25_err = 0.0
    for args, _, out, _ in matches:
        plain = ob.bm25_match_rows_plain(*args)
        bm25_err = max(bm25_err, (out - plain).abs().max().item())
        line = (f"{label}: bm25 match rows {tuple(args[1].shape)} of "
                f"{tuple(args[0].shape)}")
        log(f"  {line}: bit-equal {torch.equal(out, plain)}")
        if not torch.equal(out, plain):
            raise AssertionError(f"bm25 match kernel != plain: {line}")
    return scan_err[torch.int8], scan_err[torch.bfloat16], bm25_err


def scan_bound(rows, queries, d, block):
    """(bound ms, what bounds it) of the int8 packed scan: each input byte
    read once and the sheet written once, against 2 Q N d int8 ops."""
    nb = rows // block
    nbytes = rows * d + queries * d + nb * queries * 128 * 8
    ops = 2.0 * queries * rows * d
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def scan_ctas(queries, rows, block):
    """Thread blocks of the int8 packed scan's grid (128-query tiles)."""
    return -(-queries // 128) * (rows // block)


def bf16_scan_bound(rows, queries, d, block):
    """(bound ms, what bounds it) of the bf16 scan with per-row scales:
    corpus prefix, queries and scales read once and the sheet written
    once, against 2 Q N d bf16 flops."""
    nbytes = rows * d * 2 + queries * d * 2 + rows * 4 \
        + rows // block * queries * 128 * 8
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2.0 * queries * rows * d / BF16_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def time_scan(dense, q):
    """The scan's kernel, plain and library ms, each beside its bound: the
    int8 packed scan at the main-path shape and at the tokens wire's; the
    cascade's bf16 prefix-128 scan on the bf16 tensor-core kernel at the
    main-path shape, the tokens wire's bf16 prefix-64 scan, and the
    CUDA-core kernel at the main bf16 shape (f32 queries take it) and on
    an f32 corpus beside `torch.matmul` in full f32. Returns the JSON
    line's numbers for (the int8 scan, the bf16 scan)."""
    import torch

    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.quant import quantize_int8
    from rag_application_tpu_torch.utils import full_f32_matmul

    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q8 = quantize_int8(qn)
    kw = dict(valid_n=None, block_rows=BLOCK, mode="packed", strips=1,
              strip_outputs=False)
    scan_ms = cuda_ms(lambda: ft.scan_sheet(dense.int8, q8, None, None,
                                            **kw), reps=5)
    scan_plain_ms = cuda_ms(lambda: ft.scan_sheet_plain(
        dense.int8, q8, None, None, **kw), reps=1)
    # yardstick: the int8 product alone (cuBLASLt via torch._int_mm), which
    # also writes the (Q, N) int32 score matrix the kernel never makes
    scan_lib_ms = cuda_ms(lambda: torch._int_mm(q8, dense.int8.t()), reps=3)
    scan_bnd, scan_by = scan_bound(N, BATCH, DIM, BLOCK)
    log(f"  fused_scan int8 packed, full shape ({N}x{DIM}, {BATCH} queries, "
        f"block {BLOCK}, {scan_ctas(BATCH, N, BLOCK)} thread blocks): "
        f"kernel {scan_ms:.3f} ms, plain {scan_plain_ms:.3f} ms, "
        f"torch._int_mm {scan_lib_ms:.3f} ms, bound {scan_bnd:.3f} ms "
        f"({scan_by}), kernel at {scan_bnd / scan_ms:.1%} of the bound")
    torch.cuda.empty_cache()

    # the tokens wire's int8 scan: 262,144 stored chunks, 256 queries
    tok_rows, tok_q = 262144, 256
    tok_ms = cuda_ms(lambda: ft.scan_sheet(dense.int8[:tok_rows],
                                           q8[:tok_q], None, None, **kw),
                     reps=50)
    tok_lib_ms = cuda_ms(lambda: torch._int_mm(q8[:tok_q],
                                               dense.int8[:tok_rows].t()),
                         reps=50)
    tok_bnd, tok_by = scan_bound(tok_rows, tok_q, DIM, BLOCK)
    log(f"  fused_scan int8 packed, tokens-wire shape ({tok_rows}x{DIM}, "
        f"{tok_q} queries, block {BLOCK}, "
        f"{scan_ctas(tok_q, tok_rows, BLOCK)} thread blocks on 132 SMs): "
        f"kernel {tok_ms:.4f} ms, torch._int_mm {tok_lib_ms:.4f} ms, bound "
        f"{tok_bnd:.4f} ms ({tok_by})")

    # the cascade's bf16 prefix-128 scan (general path): bf16 queries take
    # the bf16 tensor-core kernel
    qb = qn.to(torch.bfloat16)[:, :128].contiguous()
    cb = dense.vecs[:, :128]
    inv0 = dense.inv_norms[:, 0].contiguous()
    kw = {**kw, "mode": "f32"}
    before = dict(ft.route_launches)
    bf_ms = cuda_ms(lambda: ft.scan_sheet(cb, qb, inv0, None, **kw), reps=5)
    if rose(ft.route_launches, before) != ["fused_scan_bf16"]:
        raise AssertionError("the cascade shape missed the bf16 kernel")
    bf_plain_ms = cuda_ms(lambda: ft.scan_sheet_plain(cb, qb, inv0, None,
                                                      **kw), reps=1)
    # yardstick: the bf16 product alone, (Q, N) bf16 scores written out
    bf_lib_ms = cuda_ms(lambda: torch.matmul(qb, cb.t()), reps=3)
    bf_bnd, bf_by = bf16_scan_bound(N, BATCH, 128, BLOCK)
    log(f"  fused_scan_bf16, bf16 prefix-128 path (cascade), full shape "
        f"({N}x128 of a {DIM}-wide table, {BATCH} queries, block {BLOCK}, "
        f"{-(-BATCH // 128) * (N // BLOCK)} thread blocks): kernel "
        f"{bf_ms:.3f} ms, plain {bf_plain_ms:.3f} ms, torch.matmul "
        f"{bf_lib_ms:.3f} ms, bound {bf_bnd:.3f} ms ({bf_by}), kernel at "
        f"{bf_bnd / bf_ms:.1%} of the bound")
    # the same scan with f32 queries (the same values) takes the CUDA-core
    # kernel, which odd-aligned bf16 and f32 corpora still use
    qf = qb.float()
    before = dict(ft.route_launches)
    core_ms = cuda_ms(lambda: ft.scan_sheet(cb, qf, inv0, None, **kw), reps=2)
    if rose(ft.route_launches, before) != ["fused_scan"]:
        raise AssertionError("f32 queries missed the CUDA-core kernel")
    log(f"  fused_scan CUDA-core kernel, the same scan with f32 queries: "
        f"kernel {core_ms:.3f} ms")
    # the CUDA-core kernel on its own ground, an f32 corpus: the prefix
    # rows cast to f32, beside torch.matmul in full f32 (TF32 off)
    f_rows = 262144
    cf = cb[:f_rows].float()
    if_ = inv0[:f_rows]
    before = dict(ft.route_launches)
    f_ms = cuda_ms(lambda: ft.scan_sheet(cf, qf, if_, None, **kw), reps=2)
    if rose(ft.route_launches, before) != ["fused_scan"]:
        raise AssertionError("the f32 corpus missed the CUDA-core kernel")
    f_plain_ms = cuda_ms(lambda: ft.scan_sheet_plain(cf, qf, if_, None,
                                                     **kw), reps=1)
    with full_f32_matmul():
        f_lib_ms = cuda_ms(lambda: torch.matmul(qf, cf.t()), reps=2)
    f_bytes = f_rows * 128 * 4 + BATCH * 128 * 4 + f_rows * 4 \
        + f_rows // BLOCK * BATCH * 128 * 8
    f_ops = 2.0 * BATCH * f_rows * 128
    f_bnd = max(f_bytes / HBM_BYTES_S, f_ops / F32_OPS_S) * 1e3
    log(f"  fused_scan CUDA-core kernel, f32 corpus ({f_rows}x128 f32, "
        f"{BATCH} f32 queries, block {BLOCK}): kernel {f_ms:.3f} ms, plain "
        f"{f_plain_ms:.3f} ms, torch.matmul (f32, TF32 off) {f_lib_ms:.3f} "
        f"ms, bound {f_bnd:.3f} ms (operations: the f32 dot at "
        f"{F32_OPS_S / 1e12:.0f} TFLOP/s; bytes alone "
        f"{f_bytes / HBM_BYTES_S * 1e3:.4f} ms)")
    del cf
    torch.cuda.empty_cache()

    # the tokens wire's bf16 scan: prefix 64 (128 columns loaded, the query
    # tail zeroed), 262,144 stored chunks, 256 queries: too few 128- or
    # 64-query thread blocks for the card, so the kernel takes 32-query tiles
    qt = qb[:tok_q].clone()
    qt[:, 64:] = 0
    ct, it = cb[:tok_rows], inv0[:tok_rows]
    tokb_ms = cuda_ms(lambda: ft.scan_sheet(ct, qt, it, None, **kw), reps=50)
    tokb_lib_ms = cuda_ms(lambda: torch.matmul(qt, ct.t()), reps=50)
    tokb_bnd, tokb_by = bf16_scan_bound(tok_rows, tok_q, 128, BLOCK)
    log(f"  fused_scan_bf16, tokens-wire shape ({tok_rows}x128, prefix 64, "
        f"{tok_q} queries, block {BLOCK}, "
        f"{-(-tok_q // 32) * (tok_rows // BLOCK)} thread blocks on 132 SMs): "
        f"kernel {tokb_ms:.4f} ms, torch.matmul {tokb_lib_ms:.4f} ms, bound "
        f"{tokb_bnd:.4f} ms ({tokb_by})")
    torch.cuda.empty_cache()
    return ((scan_ms, scan_plain_ms, scan_lib_ms, scan_bnd, scan_by),
            (bf_ms, bf_plain_ms, bf_lib_ms, bf_bnd, bf_by))


def kernel_times(fn, reps: int) -> dict:
    """{kernel name: (device ms per launch, launches per call)} of the
    CUDA kernels ``fn`` runs, from torch.profiler over ``reps`` calls
    after one warm-up call. Per launch, as the profiler now and then
    misses a launch of many."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):  # a window with no device events, once more
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key: (e.self_device_time_total / 1e3 / e.count,
                         e.count / reps)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count}
        if times:
            break
    return times


def time_stage2(label, args):
    """BM25's stage 2 on the card at one path's shape: before this design
    (the PyTorch gather of the candidates' packed rows, which the match
    kernel then read back) and the fused kernel that reads the rows by id,
    device times from the profiler, beside the plain version and the
    bound. "Cold" zeroes a 256 MB buffer (past the 50 MB L2) before each
    call, as the path's stage 1 streams more than the L2 holds before
    stage 2; "hot" repeats the call on rows the L2 may still hold.
    Returns (cold ms, plain_ms, None, bound_ms, bound_by)."""
    import math

    import torch

    from rag_application_tpu_torch.ops import bm25 as ob

    doc_packed, cand, qt, qv = args
    q_, pool = cand.shape
    l, t = doc_packed.shape[1] // 2, qt.shape[1]
    cl = cand.long()
    flush = torch.empty(64 << 20, dtype=torch.int32, device=cand.device)

    def cold(fn):
        return lambda: (flush.zero_(), fn())

    def others(times):
        """Device ms a call of the kernels other than the flush's fill."""
        return sum(ms * max(1, round(n)) for k, (ms, n) in times.items()
                   if "Fill" not in k)

    def match(times):
        ms, n = next((v for k, v in times.items() if "bm25_match" in k),
                     (0.0, 0.0))
        if round(n) != 1:
            raise AssertionError(f"expected one bm25_match launch a call, "
                                 f"saw {n}: {sorted(times)}")
        return ms

    packed = doc_packed[cl]
    dt, dw = packed[..., :l], packed[..., l:].view(torch.float32)
    gather = lambda: doc_packed[cl]  # noqa: E731
    on_rows = lambda: ob.bm25_match_scores(dt, dw, qt, qv)  # noqa: E731
    fused = lambda: ob.bm25_match_rows(doc_packed, cand, qt, qv)  # noqa: E731
    g_hot, g_cold = others(kernel_times(gather, 20)), \
        others(kernel_times(cold(gather), 20))
    r_hot, r_cold = match(kernel_times(on_rows, 20)), \
        match(kernel_times(cold(on_rows), 20))
    del packed, dt, dw
    f_hot, f_cold = match(kernel_times(fused, 20)), \
        match(kernel_times(cold(fused), 20))
    # what the fused kernel waits on: the same rows with the query side
    # cut (T 1: no sort, no search step; T 8: three steps), and every
    # candidate the sentinel row (its row stays in L2)
    sent = torch.full_like(cand, doc_packed.shape[0] - 1)
    parts = {f"T {tt}": (doc_packed, cand, qt[:, :tt].contiguous(),
                         qv[:, :tt].contiguous()) for tt in (1, 8)}
    parts["all sentinel"] = (doc_packed, sent, qt, qv)
    cut = []
    for k, a in parts.items():
        fn = cold(lambda a=a: ob.bm25_match_rows(*a))
        cut.append(f"{k} {match(kernel_times(fn, 20)):.5f}")
    log(f"  bm25 stage 2, {label}, the fused kernel with parts of its work "
        f"cut (device ms cold): {', '.join(cut)}")
    del flush, sent, parts
    plain_ms = device_ms(
        lambda: ob.bm25_match_rows_plain(doc_packed, cand, qt, qv), 3)
    # each input read once: the ids, the distinct rows they name, the
    # query terms and flags; the scores written once. Operations: a
    # search of ceil(log2 T) steps and an add for each doc term, and the
    # T x T rank counts of the sort.
    rows = torch.unique(cand).numel()
    nbytes = q_ * pool * 4 + rows * 2 * l * 4 + q_ * t * 5 + q_ * pool * 4
    ops = q_ * pool * l * (math.ceil(math.log2(max(t, 2))) + 1) + q_ * t * t
    bound = max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_S >= ops / F32_OPS_S else "operations"
    log(f"  bm25 stage 2, {label}: cand {tuple(cand.shape)}, L {l}, T {t}; "
        f"device ms cold / hot. Before: the gather of the packed rows "
        f"{g_cold:.5f} / {g_hot:.5f}, then the match on the gathered rows "
        f"({r_cold:.5f} / {r_hot:.5f} with this design's kernel). After: "
        f"bm25_match_rows {f_cold:.5f} / {f_hot:.5f}. Plain {plain_ms:.4f};"
        f" bound {bound:.5f} ({by}: {nbytes / 1e6:.2f} MB, {rows:,} distinct "
        f"rows)")
    return f_cold, plain_ms, None, bound, by


def time_kernels(dense, q, bm25_args):
    """Kernel, plain and library ms at the full main-path shapes."""
    scan_t, scan_bf_t = time_scan(dense, q)
    return scan_t, scan_bf_t, time_stage2("main path", bm25_args)


def run_main_path(dense, sparse, tokens, rng):
    """The port's entry point on full batches; returns (batch ms list,
    recall@10, launch counts, (int8 scan, bf16 scan, bm25) max abs err of
    one more cascade batch's launches against their plain versions)."""
    import torch

    from rag_application_tpu_torch.config import FunnelConfig
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.rrf import INVALID_ID
    from rag_application_tpu_torch.search import fused as fs
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

    reset_scan_counts(ft)
    ob.bm25_match_rows.launches = 0
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
                     f"{getattr(ft.fused_scan_topk, 'last_path', None)}")
        log(lines[-1])
    launches = {**scan_counts(ft),
                "bm25_match": ob.bm25_match_rows.launches}
    if ft.route_launches["fused_scan"]:
        raise AssertionError(f"the main path fell to the CUDA-core scan "
                             f"kernel: {ft.route_launches}")
    if ob.bm25_match_scores.launches:
        raise AssertionError("bm25_topk reached the gathered-rows entry "
                             "bm25_match_scores")
    profile_batch(searcher, *batches[0], funnel)
    # one more cascade batch, its kernel launches held against plain
    with recording(ft, "scan_sheet", ft.route_launches) as scans, \
            recording(ob, "bm25_match_rows") as matches, \
            recording(fs, "bm25_topk") as topks:
        searcher.search(*batches[3], K, use_matryoshka=True, funnel=funnel)
    errs = check_recorded("cascade batch", scans, matches)
    touched = check_no_gathered_copy(topks[0])
    log(f"  bm25_topk on the card: the table is touched only by views "
        f"({sorted(set(touched))}), no gathered copy; one bm25_match_rows "
        f"launch")
    del scans, matches, topks

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
    return times, recall, launches, errs


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
    stage2 = sum(e.self_device_time_total for e in kern
                 if "bm25_match" in e.key) / 1e3
    log(f"  BM25 stage 2 (the bm25_match kernel, reading its rows by id): "
        f"{stage2:.4f} ms ({stage2 / busy:.2%} of the device's busy time)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<4d} "
            f"{e.key[:96]}")


def prep_inputs(dev, n, d, seed, special=False):
    """Spectrally decaying gaussian rows (as build_tables), on the card;
    with ``special`` a zero row and rows scaled by 1e-3 and 1e3."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.exp(-0.003 * torch.arange(d, dtype=torch.float32,
                                            device=dev))
    x = torch.randn((n, d), generator=gen, device=dev) * scale
    if special:
        x[0] = 0.0
        x[1::3] *= 1e-3
        x[2::3] *= 1e3
    return x


def check_prep(dev):
    """Kernel vs plain, bit for bit (the plain version adds in the
    kernel's order): the fresh-tensor entry `prepare_vectors` at six
    shapes, then the in-place entry `prepare_vectors_into` at three start
    offsets of index-shaped planes filled with random bits, whose rows
    outside the written range must stay as they were. Zero rows give
    zeros and inverse norms of 1e6. Returns the worst max abs error of
    the bf16 plane."""
    import torch

    from rag_application_tpu_torch.ops import quant as oq

    def same(a, b):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        return torch.equal(a, b)

    cases = [(f"slab {PREP_SLAB} x {DIM}", PREP_SLAB, DIM, PREP_DIMS, False),
             (f"document {EMB_BATCH} x {DIM}", EMB_BATCH, DIM, PREP_DIMS,
              False),
             (f"1 x {DIM}", 1, DIM, PREP_DIMS, False),
             ("1037 x 100", 1037, 100, (16, 100), False),
             (f"4096 x {DIM}", 4096, DIM, (), False),
             (f"zero + 1e-3/1e3-scaled rows, 300 x {DIM}", 300, DIM,
              PREP_DIMS, True)]
    worst = 0.0
    for i, (label, n, d, dims, special) in enumerate(cases):
        x = prep_inputs(dev, n, d, 20 + i, special)
        kern = oq.prepare_vectors(x, dims)
        plain = oq.prepare_vectors_plain(x, dims)
        torch.cuda.synchronize()
        err = (kern[0].float() - plain[0].float()).abs().max().item()
        equal = [same(a, b) for a, b in zip(kern, plain)]
        log(f"  prep {label}, dims {dims}: bf16 / int8 / inv_norms "
            f"bit-equal {equal}; bf16 max_abs_err {err:.3g}")
        ok = all(equal)
        if special:
            ok = ok and not kern[0][0].float().any() and not kern[1][0].any() \
                and bool((kern[2][0] == 1e6).all().item())
        if not ok:
            raise AssertionError(f"prep_vectors kernel != plain: {label}")
        worst = max(worst, err)

    # the in-place entry: rows [start, start + n) of a 4096-row index's
    # planes, between guard rows of random bits
    cap = 4096
    gen = torch.Generator(device=dev).manual_seed(7)
    for start, n in ((0, EMB_BATCH), (1000, EMB_BATCH), (cap - 1037, 1037)):
        planes = [
            torch.randint(-2**15, 2**15, (cap, DIM), generator=gen,
                          device=dev, dtype=torch.int16).view(torch.bfloat16),
            torch.randint(-128, 128, (cap, DIM), generator=gen, device=dev,
                          dtype=torch.int8),
            torch.randn((cap, len(PREP_DIMS)), generator=gen, device=dev),
            torch.rand((cap,), generator=gen, device=dev) > 0.5]
        before = [p.clone() for p in planes]
        x = prep_inputs(dev, n, DIM, 60 + start, special=True)
        oq.prepare_vectors_into(x, PREP_DIMS, *planes, start)
        want = (*oq.prepare_vectors_plain(x, PREP_DIMS),
                torch.ones(n, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        end = start + n
        rows = [same(p[start:end], w) for p, w in zip(planes, want)]
        guards = [same(p[:start], b[:start]) and same(p[end:], b[end:])
                  for p, b in zip(planes, before)]
        log(f"  prep in place, rows [{start}, {end}) of {cap}: vecs / int8 /"
            f" inv_norms / live bit-equal {rows}, guard rows untouched "
            f"{guards}")
        if not all(rows) or not all(guards):
            raise AssertionError(f"prepare_vectors_into at {start}: rows "
                                 f"{rows}, guards {guards}")
    return worst


def device_ms(fn, reps: int, match: str | None = None, *more: str):
    """Mean device time per call of ``fn``: the self device time of the
    CUDA kernels it ran (those whose name holds ``match``, if given),
    from torch.profiler over ``reps`` calls. Unlike CUDA events around
    back-to-back calls, it leaves out the gaps in which the device waits
    for the host to enqueue the next launch. With ``more`` names, returns
    one time per name (``match`` first), all from the same calls. A
    profiled run that recorded no device time for a name (it has
    happened once in many) is profiled again once before this raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        us = [sum(e.self_device_time_total for e in kern
                  if name is None or name in e.key) for name in (match, *more)]
        if min(us) > 0:
            out = [u / 1e3 / reps for u in us]
            return tuple(out) if more else out[0]
    raise AssertionError(f"the profiler saw no device time ({match}, {more})")


def time_prep(dev):
    """Kernel and plain ms at the slab and the document shape, beside the
    bytes bound (the function moves 4d bytes in and 3d + 4M + 1 out per
    row). The kernel is timed as `DenseIndex.insert` launches it, in
    place into an index's planes (rows 1000 on for the document), and
    beside it through the fresh-tensor entry. The times are device times
    from the profiler; at the document shape CUDA events around
    back-to-back calls measure the host's enqueue rate instead, which is
    logged beside them. Returns (ms, plain_ms, None, bound_ms, bound_by)
    for each, the slab's first; the document's is the shape `[ingest]`
    launches."""
    import torch

    from rag_application_tpu_torch.ops import quant as oq

    def prep_ms(times):
        ms, n = next((v for k, v in times.items() if "prep_vectors_" in k),
                     (0.0, 0.0))
        if round(n) != 1:
            raise AssertionError(f"expected one prep launch a call, saw {n}")
        return ms

    out = []
    for n, start, reps in ((PREP_SLAB, 0, 20), (EMB_BATCH, 1000, 200)):
        x = prep_inputs(dev, n, DIM, 40)
        cap = start + n
        planes = (torch.zeros((cap, DIM), dtype=torch.bfloat16, device=dev),
                  torch.zeros((cap, DIM), dtype=torch.int8, device=dev),
                  torch.zeros((cap, len(PREP_DIMS)), device=dev),
                  torch.zeros((cap,), dtype=torch.bool, device=dev))
        run = lambda: oq.prepare_vectors_into(  # noqa: E731
            x, PREP_DIMS, *planes, start)
        fresh = lambda: oq.prepare_vectors(x, PREP_DIMS)  # noqa: E731
        plain = lambda: oq.prepare_vectors_plain(x, PREP_DIMS)  # noqa: E731
        ms = prep_ms(kernel_times(run, reps))
        fresh_ms = prep_ms(kernel_times(fresh, reps))
        plain_ms = device_ms(plain, max(5, reps // 10))
        paced = cuda_ms(run, reps=reps)
        paced_plain = cuda_ms(plain, reps=max(5, reps // 10))
        nbytes = n * DIM * 4 + n * DIM * 3 + n * len(PREP_DIMS) * 4 + n
        ops = n * DIM * (8 + len(PREP_DIMS))
        bound = max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= ops / F32_OPS_S \
            else "operations"
        log(f"  prep_vectors {n} x {DIM}, dims {PREP_DIMS}: kernel in place "
            f"{ms:.5f} ms (into new tensors {fresh_ms:.5f}), plain "
            f"{plain_ms:.5f} ms (device time, profiler); back-to-back calls "
            f"by CUDA events: kernel {paced:.5f} ms, plain {paced_plain:.5f}"
            f" ms; bound {bound:.5f} ms ({by}: {nbytes / 1e6:.3f} MB), no "
            f"library call")
        out.append((ms, plain_ms, None, bound, by))
        del planes
    # what a document's launch waits on: the same kernel with parts of its
    # work taken away through its arguments (one row: one warp's chain;
    # no prefix dims; no bf16 / int8 planes written)
    x = prep_inputs(dev, EMB_BATCH, DIM, 40)
    cap = 1000 + EMB_BATCH
    inv = torch.zeros((cap, len(PREP_DIMS)), device=dev)
    live = torch.zeros((cap,), dtype=torch.bool, device=dev)
    vecs = torch.zeros((cap, DIM), dtype=torch.bfloat16, device=dev)
    i8 = torch.zeros((cap, DIM), dtype=torch.int8, device=dev)
    parts = {
        "one row": lambda: oq.prepare_vectors_into(
            x[:1], PREP_DIMS, vecs, i8, inv, live, 1000),
        "no prefix dims": lambda: oq.prepare_vectors_into(
            x, (), vecs, i8, inv[:, :0].contiguous(), live, 1000),
        "no planes written": lambda: oq.prepare_vectors_into(
            x, PREP_DIMS, None, None, inv, live, 1000),
        "one row, nothing but live": lambda: oq.prepare_vectors_into(
            x[:1], (), None, None, inv[:, :0].contiguous(), live, 1000)}
    log(f"  prep_vectors {EMB_BATCH} x {DIM} with parts of its work taken "
        f"away (device ms a launch): " + ", ".join(
            f"{k} {prep_ms(kernel_times(fn, 200)):.5f}"
            for k, fn in parts.items()))
    return out


def ingest_texts(rng):
    """INGEST_DOCS x INGEST_CHUNKS chunk texts: 24-word zipf bag-of-words
    over a 50k vocabulary (bench.py's synth_tokens), and their tokens."""
    tokens = synth_tokens(rng, INGEST_DOCS * INGEST_CHUNKS)
    texts = [" ".join(f"w{t}" for t in row) for row in tokens]
    return tokens, texts


def run_ingest(dev):
    """The write path: Embedder.encode then store_document_vectors, one
    call each per document, then a document's `DenseIndex.insert` alone
    under the profiler, which must be the upload and one in-place prep
    launch. Returns (collection, embedder, tokens, texts,
    prepare_vectors_into launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rag_application_tpu_torch.config import Config, EncoderConfig
    from rag_application_tpu_torch.index.dense import DenseIndex
    from rag_application_tpu_torch.models.embedder import Embedder
    from rag_application_tpu_torch.ops import quant as oq
    from rag_application_tpu_torch.store.collection import Collection

    t0 = time.perf_counter()
    tokens, texts = ingest_texts(np.random.default_rng(5))
    emb = Embedder(cfg=EncoderConfig(), max_len=EMB_LEN,
                   batch_size=EMB_BATCH, device=dev)
    col = Collection("user_smoke", Config(), device=dev)
    nparams = sum(t.numel() for t in emb.state.params.values())
    emb.encode(["warm up the encoder"])
    torch.cuda.synchronize()
    log(f"  set-up {time.perf_counter() - t0:.1f} s: {len(texts):,} chunk "
        f"texts, encoder {nparams / 1e6:.2f}M params (random, seed 0)")

    torch.cuda.reset_peak_memory_stats()
    oq.prepare_vectors_into.launches = 0
    oq.prepare_vectors.launches = 0
    enc_host, store_host, marks = [], [], []
    busy = wall = None
    t_start = time.perf_counter()
    for i in range(INGEST_DOCS):
        chunk_texts = texts[i * INGEST_CHUNKS:(i + 1) * INGEST_CHUNKS]
        chunks = [{"text": t, "page": i} for t in chunk_texts]
        prof = None
        if i == INGEST_DOCS - 1:  # the last document, under the profiler
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t_start
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        t0 = time.perf_counter()
        vecs = emb.encode(chunk_texts)
        ev[1].record()
        t1 = time.perf_counter()
        col.store_document_vectors(f"doc-{i}", chunks, vecs)
        ev[2].record()
        t2 = time.perf_counter()
        enc_host.append(t1 - t0)
        store_host.append(t2 - t1)
        marks.append(ev)
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            wall = ev[0].elapsed_time(ev[2])
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kern) / 1e3
    launches = oq.prepare_vectors_into.launches
    fresh = oq.prepare_vectors.launches
    # rates and means over the unprofiled documents
    marks, enc_host, store_host = marks[:-1], enc_host[:-1], store_host[:-1]
    enc_ev = [e[0].elapsed_time(e[1]) for e in marks]
    store_ev = [e[1].elapsed_time(e[2]) for e in marks]
    n = INGEST_DOCS * INGEST_CHUNKS
    timed = (INGEST_DOCS - 1) * INGEST_CHUNKS
    log(f"  {INGEST_DOCS} documents x {INGEST_CHUNKS} chunks = {n:,} chunks;"
        f" the first {INGEST_DOCS - 1} documents in {total_s:.2f} s -> "
        f"{timed / total_s:,.0f} chunks/s")
    log(f"  per document: encode {np.mean(enc_ev):.3f} ms (CUDA events; "
        f"host {np.mean(enc_host) * 1e3:.3f} ms, median "
        f"{np.median(enc_host) * 1e3:.3f}), store {np.mean(store_ev):.3f} ms"
        f" (CUDA events; host {np.mean(store_host) * 1e3:.3f} ms, median "
        f"{np.median(store_host) * 1e3:.3f})")
    log(f"[profile] one ingested document: {wall:.3f} ms wall (CUDA "
        f"events); device busy {busy:.3f} ms ({busy / wall:.1%}), idle "
        f"{1 - busy / wall:.1%}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    log(f"  device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
        f"prepare_vectors_into launches {launches} (one per document: "
        f"{INGEST_DOCS}), prepare_vectors {fresh}; encoder cache "
        f"{len(emb.cache)} entries")
    if launches != INGEST_DOCS or fresh:
        raise AssertionError(f"prep launched {launches} times in place and "
                             f"{fresh} into new tensors for {INGEST_DOCS} "
                             f"documents")
    if col.chunk_count() != n or col.dense.size != n:
        raise AssertionError(f"stored {col.chunk_count()} chunks, not {n}")

    # one document's DenseIndex.insert alone: the upload of its vectors
    # and one prep launch, which writes the planes and the live flags
    # (20 inserts under the profiler, which now and then misses a launch
    # of a short window)
    idx = DenseIndex(Config().index, device=dev)
    idx.insert(vecs)
    times = kernel_times(lambda: idx.insert(vecs), 20)
    kernels = {k: n for k, (_, n) in times.items()
               if not k.startswith("Memcpy")}
    log(f"  DenseIndex.insert of one document ({vecs.shape[0]} x "
        f"{vecs.shape[1]}, Config().index), device operations an insert: "
        f"{ {k[:60]: round(n, 2) for k, (_, n) in times.items()} }")
    if len(kernels) != 1 or round(next(iter(kernels.values()))) != 1 \
            or "prep_vectors_" not in next(iter(kernels)):
        raise AssertionError(f"DenseIndex.insert ran {kernels}, not one "
                             f"prep launch")
    return col, emb, tokens, texts, launches


def noisy_texts(tokens, idx, seed):
    """Stored chunks with ~TOK_FLIP of their words resampled (bench.py's
    noisy_tokens)."""
    r = np.random.default_rng(seed)
    t = tokens[idx].copy()
    flip = r.random(t.shape) < TOK_FLIP
    t[flip] = r.integers(0, VOCAB, int(flip.sum()))
    return [" ".join(f"w{w}" for w in row) for row in t]


def exact_scores(dense, q, rows):
    """f32 dense scores of normalized queries ``q`` (Q, d) against
    ``rows`` (Q, k) of the bf16 plane, as the final rescore computes
    them."""
    import torch

    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=1e-12)
    r = torch.as_tensor(rows, device=q.device).long()
    return (dense.vecs[r].float() * qn[:, None, :]).sum(-1)


def run_tokens(col, emb, tokens):
    """The tokens wire over the ingested Collection; returns (ms/batch
    list, recall@10, near-ties, launches, (int8 scan, bf16 scan, bm25)
    max abs err of the path's launches against their plain versions)."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft

    col.bind_query_encoder(emb)
    n = col.dense.size
    rng = np.random.default_rng(9)
    batches = []
    for b in range(TOK_BATCHES):
        idx = rng.integers(0, n, size=TOK_BATCH)
        batches.append((idx, noisy_texts(tokens, idx, 600 + b)))
    # warm-up at the batch shape (and the sparse rebuild after ingest)
    col.hybrid_search_text_batch(batches[0][1], K)
    torch.cuda.synchronize()

    reset_scan_counts(ft)
    ob.bm25_match_rows.launches = 0
    ob.bm25_match_scores.launches = 0
    times, results = [], []
    for _, texts in batches:
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        hits = col.hybrid_search_text_batch(texts, K)
        ev1.record()
        torch.cuda.synchronize()
        times.append((ev0.elapsed_time(ev1),
                      (time.perf_counter() - t0) * 1e3))
        results.append(hits)
    launches = {**scan_counts(ft),
                "bm25_match": ob.bm25_match_rows.launches}
    if ft.route_launches["fused_scan"]:
        raise AssertionError(f"the tokens wire fell to the CUDA-core scan "
                             f"kernel: {ft.route_launches}")
    if ob.bm25_match_scores.launches:
        raise AssertionError("the tokens wire reached the gathered-rows "
                             "entry bm25_match_scores")
    log(f"  hybrid_search_text_batch, {TOK_BATCHES} batches of {TOK_BATCH}: "
        f"ms/batch (CUDA events) {[round(t[0], 2) for t in times]}, host "
        f"{[round(t[1], 2) for t in times]}; launches {launches}")
    # the path's own kernel launches (the cascade's bf16 prefix scan, the
    # int8 scan, the BM25 match at the collection's pool) against plain
    with recording(ft, "scan_sheet", ft.route_launches) as scans, \
            recording(ob, "bm25_match_rows") as matches:
        col.hybrid_search_text_batch(batches[0][1], K)
    errs = [check_recorded("tokens wire", scans, matches)]
    time_stage2("tokens wire", matches[0][0])
    del scans, matches

    # decomposition of one batch: host tokenize, sparse query encode,
    # upload of the ids, device (encoder forward + funnel)
    texts = batches[1][1]
    fused = col._fused
    t0 = time.perf_counter()
    ids, amask = emb.tokenizer.encode_batch(texts, emb.max_len)
    t_tok = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sq = col.sparse.encode_queries(texts)
    torch.cuda.synchronize()
    t_sparse = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ids_d = torch.from_numpy(ids).to(col.device)
    am_d = torch.from_numpy(amask).to(col.device)
    torch.cuda.synchronize()
    t_up = (time.perf_counter() - t0) * 1e3
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    fused.search_tokens_prepared((ids_d, am_d, sq), K,
                                 funnel=col._funnel(None, True))
    ev1.record()
    torch.cuda.synchronize()
    log(f"  one batch apart: host tokenize {t_tok:.2f} ms, sparse query "
        f"encode {t_sparse:.2f} ms, upload {t_up:.3f} ms ({ids.nbytes + amask.nbytes:,} B),"
        f" device (encoder + funnel) {ev0.elapsed_time(ev1):.2f} ms")

    # the tokens wire against encode-then-search, batch by batch
    ties, worst_gap, compared = 0, 0.0, 0
    q_first = None
    for (idx, texts), tok_hits in zip(batches, results):
        vecs = emb.encode(texts)
        vec_hits = col.hybrid_search_batch(vecs, texts, K)
        ids_b, am_b = emb.tokenizer.encode_batch(texts, emb.max_len)
        q_tok = emb.state.model.apply(
            emb.state.params, torch.from_numpy(ids_b).to(col.device),
            torch.from_numpy(am_b).to(col.device))
        q_vec = torch.from_numpy(vecs).to(col.device)
        if q_first is None:
            q_first = q_tok
        dq = torch.linalg.vector_norm(q_tok - q_vec, dim=-1)
        for qi, (a, b) in enumerate(zip(vec_hits, tok_hits)):
            ra, rb = [h.row for h in a], [h.row for h in b]
            compared += 1
            if ra == rb:
                continue
            if len(ra) != len(rb):
                raise AssertionError(f"tokens wire: {len(rb)} hits vs "
                                     f"{len(ra)} (query {qi})")
            sa = exact_scores(col.dense, q_vec[qi:qi + 1], [ra])[0]
            sb = exact_scores(col.dense, q_vec[qi:qi + 1], [rb])[0]
            gap = (sa - sb).abs().max().item()
            tol = 2.01 * dq[qi].item() + 1e-5
            if gap > tol:
                raise AssertionError(
                    f"tokens wire rows differ beyond a near-tie (query {qi}"
                    f": gap {gap:.3g} > {tol:.3g}): {ra} vs {rb}")
            ties += 1
            worst_gap = max(worst_gap, gap)
    log(f"  tokens wire vs encode-then-search on {compared} queries: "
        f"{ties} near-ties (worst positional score gap {worst_gap:.3g}; a "
        f"flip needs a gap <= 2 |q_tok - q_vec|, max |dq| "
        f"{dq.max().item():.3g} in the last batch)")

    exact = exact_top_ids(col.dense, q_first[:N_EVAL], K)
    got = [[h.row for h in hits] for hits in results[0][:N_EVAL]]
    recall = float(np.mean([np.isin(exact[r], got[r]).mean()
                            for r in range(N_EVAL)]))
    log(f"  recall@10 vs exact (encoded queries over the bf16 plane) on "
        f"{N_EVAL} queries: {recall:.4f}")

    # delete one document; the masked scan must never return its rows
    victim = results[0][0][0].payload["document_id"]
    before = col.chunk_count()
    rows = col.payloads.rows_where(document_id=victim)
    removed = col.delete_document(victim)
    texts = batches[0][1]
    ids_b, am_b = emb.tokenizer.encode_batch(texts, emb.max_len)
    _, raw = col._fused.search_tokens(ids_b, texts, K, attn_mask=am_b,
                                      funnel=col._funnel(None, True))
    with recording(ft, "scan_sheet", ft.route_launches) as scans, \
            recording(ob, "bm25_match_rows") as matches:
        after_hits = col.hybrid_search_text_batch(texts, K)
    if not all(args[3] is not None for args, _, _, _ in scans):
        raise AssertionError("a scan after delete_document ran unmasked")
    errs.append(check_recorded("after delete_document", scans, matches))
    leaked = int(np.isin(raw.cpu().numpy(), rows).sum())
    from_victim = sum(h.payload["document_id"] == victim
                      for hits in after_hits for h in hits)
    log(f"  delete_document({victim!r}): removed {removed}, chunk_count "
        f"{before} -> {col.chunk_count()}; next batch: {leaked} raw rows and "
        f"{from_victim} hits from it; masked scan path "
        f"{getattr(ft.fused_scan_topk, 'last_path', None)}")
    if removed != INGEST_CHUNKS or col.chunk_count() != before - \
            INGEST_CHUNKS or leaked or from_victim:
        raise AssertionError("delete_document left rows or hits behind")
    return times, recall, ties, launches, tuple(map(max, zip(*errs)))



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


def attn_byte_inputs(dev, B, S, KVH, G, hd, seed, one_visible=False):
    """Random queries and scales over K and V rows whose bytes run through
    every value from -128 to 127 (strided walks of the byte ring), and a
    random mask, or with ``one_visible`` one visible slot a row."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    qg = torch.randn((B, 1, KVH, G, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    idx = torch.arange(B * S * KVH * hd, device=dev)
    k8 = ((idx * 37 + 11) % 256 - 128).to(torch.int8).reshape(B, S, KVH, hd)
    v8 = ((idx * 53 + 5) % 256 - 128).to(torch.int8).reshape(B, S, KVH, hd)
    ks = torch.rand((B, S, KVH), generator=gen, device=dev) * 0.015 + 0.005
    vs = torch.rand((B, S, KVH), generator=gen, device=dev) * 0.015 + 0.005
    if one_visible:
        mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
        slot = torch.randint(0, S, (B,), generator=gen, device=dev)
        mask[torch.arange(B, device=dev), slot] = True
    else:
        mask = torch.rand((B, S), generator=gen, device=dev) > 0.3
    return qg, {"q": k8, "s": ks}, {"q": v8, "s": vs}, mask


def one_slot_output(args):
    """The output when each row sees one slot: p = 1 and l = 1 there, so
    every head of a kv head gets bf16(bf16(v_scale) * v8) of that slot."""
    import torch

    qg, _, cv, mask = args
    B, _, KVH, G, hd = qg.shape
    rows = torch.arange(B, device=qg.device)
    slot = mask.to(torch.int8).argmax(dim=1)
    vsb = cv["s"][rows, slot].to(torch.bfloat16).float()          # (B, KVH)
    want = (vsb[..., None] * cv["q"][rows, slot].float()).to(torch.bfloat16)
    return want[:, None, :, None, :].expand(B, 1, KVH, G, hd)


def check_decode_attn(dev):
    """Kernel vs plain at nine geometries; each case within 2 bf16 ulps of
    max|out| (the kernel rounds p*v_scale against its chunk's max, the
    plain version against the row's), fully masked rows exactly 0. The
    case with one visible slot a row must equal the plain version and
    bf16(bf16(v_scale) * v8) bit for bit: every byte value goes through
    the kernel's conversion once there, and nothing else rounds. Returns
    (worst max abs err, main-shape inputs)."""
    import torch

    from rag_application_tpu_torch.ops import decode_attn as da

    worst, main = 0.0, None
    cases = [("main decode shape, masked prefix + empty row", ATTN_MAIN,
              "masked"), ("B 1, S 256", (1, 256, 4, 8, 64), "random"),
             ("S 288 (no multiple of 256)", (GEN_B, 288, 4, 8, 64), "random"),
             ("KVH 8, hd 128", (8, 1024, 8, 4, 128), "masked"),
             ("G 7 (a padded head tile)", (16, 1024, 4, 7, 64), "masked"),
             ("G 16 (two head tiles)", (16, 1024, 4, 16, 64), "masked"),
             ("B 1, S 1024 (the chat's shape)", (1, 1024, 4, 8, 64),
              "random"),
             ("K and V bytes -128..127", ATTN_MAIN, "bytes"),
             ("bytes -128..127, one visible slot a row", ATTN_MAIN, "one")]
    for i, (label, (B, S, KVH, G, hd), kind) in enumerate(cases):
        if kind in ("bytes", "one"):
            args = attn_byte_inputs(dev, B, S, KVH, G, hd, 11 + i,
                                    one_visible=kind == "one")
        else:
            args = attn_inputs(dev, B, S, KVH, G, hd, 11 + i,
                               kind == "masked")
        k_out = da.decode_attend_int8(*args)
        p_out = da.decode_attend_int8_plain(*args)
        torch.cuda.synchronize()
        err = (k_out.float() - p_out.float()).abs().max().item()
        bound = 2 * bf16_ulp(p_out.float().abs().max().item())
        empty = ~args[3].any(dim=1)
        zero = bool((k_out[empty] == 0).all().item())
        exact = ""
        if kind == "one":
            bound = 0.0
            same = bool(torch.equal(k_out, one_slot_output(args)))
            exact = f", equal to bf16(bf16(v_scale) * v8): {same}"
            zero = zero and same
        log(f"  decode_attn {label} (B {B}, S {S}, KVH {KVH}, G {G}, hd "
            f"{hd}, chunk {da._pick_chunk(B, KVH, G, S, hd)}): max_abs_err "
            f"{err:.3g} (bound {bound:.3g}), {int(empty.sum())} empty rows "
            f"exactly 0: {zero}{exact}")
        if err > bound or not zero:
            raise AssertionError(f"decode_attn kernel != plain: {label}")
        worst = max(worst, err)
        if i == 0:
            main = args
        del args, k_out, p_out
    return worst, main


def time_decode_attn(dev, main):
    """Kernel, plain and library ms at the main decode shape and at the
    chat's B 1, S 1024, beside the bytes bound. Kernel and library times
    are device times from the profiler: a call's kernels take less time
    than the wrapper's host work, so CUDA events around back-to-back calls
    measure the host's enqueue rate (logged beside them). The kernel is
    timed on one cache called again and again ("hot": what the 50 MB L2
    keeps of it between calls is read from there) and cycling over copies
    of the cache that together exceed the L2 ("cold": a decode step's 22
    layers read 22 caches, 740 MB at the main shape). Returns the main
    shape's (cold ms, plain ms, SDPA ms, bound ms, bound_by): `generate`
    reads its caches cold."""
    import itertools

    import torch
    import torch.nn.functional as F

    from rag_application_tpu_torch.ops import decode_attn as da

    out = None
    chat = attn_inputs(dev, 1, CHAT_PROMPT + CHAT_NEW, 4, 8, 64, 31)
    for label, args in (("main decode shape", main), ("chat, B 1", chat)):
        qg, ck, cv, mask = args
        B, _, KVH, G, hd = qg.shape
        S = ck["q"].shape[1]
        nbytes = (2 * ck["q"].numel() + 2 * ck["s"].numel() * 4 + mask.numel()
                  + 2 * qg.numel() * 2)
        copies = [args] + [
            (qg, {k: t.clone() for k, t in ck.items()},
             {k: t.clone() for k, t in cv.items()}, mask)
            for _ in range(-(-160_000_000 // nbytes) - 1)]
        run = lambda: da.decode_attend_int8(*args)  # noqa: E731
        it = itertools.cycle(copies)
        reps = len(copies) * max(1, 400 // len(copies))
        cold = device_ms(lambda: da.decode_attend_int8(*next(it)), reps,
                         match="decode_attn")
        hot, split = device_ms(run, 200, "decode_attn", "decode_attn_split")
        paced = cuda_ms(run, reps=200)
        del copies, it
        plain_ms = cuda_ms(lambda: da.decode_attend_int8_plain(*args), reps=5)

        # yardstick: SDPA on K/V dequantized to bf16 beforehand (timed apart)
        def deq(c):
            return (c["q"].float() * c["s"][..., None]).to(
                torch.bfloat16).transpose(1, 2)          # (B, KVH, S, hd)

        deq_ms = cuda_ms(lambda: (deq(ck), deq(cv)), reps=5)
        k, v = deq(ck), deq(cv)
        q = qg.reshape(B, KVH * G, 1, hd)
        am = mask[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=am, enable_gqa=True), 50)
        del k, v
        ops = 2 * 2 * B * KVH * G * S * hd
        bound = max(nbytes / HBM_BYTES_S, ops / BF16_OPS_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= ops / BF16_OPS_S \
            else "operations"
        chunk = da._pick_chunk(B, KVH, G, S, hd)
        log(f"  decode_attn {label} {tuple(ck['q'].shape)}, chunk {chunk} "
            f"({B * KVH * -(-S // chunk)} blocks, "
            f"{da.resident_blocks(G, hd, chunk)} a SM at once): kernel cold "
            f"{cold:.4f} ms "
            f"({-(-160_000_000 // nbytes)} caches in turn), hot {hot:.4f} ms "
            f"(one cache; split {split:.4f} + merge {hot - split:.4f}) "
            f"(device time, profiler); back-to-back calls by CUDA events "
            f"{paced:.4f} ms; plain {plain_ms:.4f} ms; SDPA (bf16 K/V, "
            f"enable_gqa) {lib_ms:.4f} ms (device time) + dequantization "
            f"{deq_ms:.4f} ms (CUDA events); bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB)")
        if out is None:
            out = (cold, plain_ms, lib_ms, bound, by)
    return out


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
    pad = -1              # no token: every slot of the output counts

    dec.generate(params, cfg, ids[:, :64], plen // 14, 2, eos, pad)  # warm-up
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
    reset_scan_counts(ft)
    ob.bm25_match_rows.launches = 0
    da.decode_attend_int8.launches = 0
    t0 = time.perf_counter()
    ev[2].record()
    out, n = dec.generate(params, cfg, ids, plen, GEN_NEW, eos, pad)
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
    if not (n.cpu().numpy() == GEN_NEW).all():
        raise AssertionError(f"generate stopped early: {n.min().item()} of "
                             f"{GEN_NEW} tokens in some row")
    want = cfg.num_layers * GEN_NEW  # one launch per layer per decode step
    log(f"  decode_attn launches in generate: {launches} (the loop implies "
        f"{cfg.num_layers} layers x {GEN_NEW} steps = {want}); fused_scan "
        f"{ft.scan_sheet.launches}, bm25_match "
        f"{ob.bm25_match_rows.launches}")
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


def attn_only(dev, card) -> int:
    """`--attn`: the decode-attention kernel's checks and times alone, for
    kernel work on it (no tables, search, write path or generation)."""
    log("[gen-check] decode_attn kernel vs plain on the card")
    err, args = check_decode_attn(dev)
    log(f"[gen-check] every case held; max abs err {err:.3g}")
    log(f"[gen-time] decode_attn at the main decode shape and the chat's "
        f"({card})")
    time_decode_attn(dev, args)
    log(card)
    return 0


def scan_only(dev, card) -> int:
    """`--scan`: the scan kernel's checks and times alone, for kernel work
    on the scan (dense tables only; no search, write path or generation)."""
    dense, cap, t_dense = build_dense(dev)
    log(f"[tables] dense {N}x{DIM} built in {t_dense:.1f} s")
    q, _ = make_queries(dense, None, np.random.default_rng(0), 1)
    log("[check] scan kernel vs plain on the card")
    errs, n_cases = check_scan(dense, cap, q)
    log(f"[check] {n_cases} scan cases passed; max abs err by kernel {errs}")
    del cap
    log(f"[time] scan at the main-path shapes ({card})")
    time_scan(dense, q)
    log(card)
    return 0


def match_prep_only(dev, card) -> int:
    """`--match-prep`: the BM25 match and prep kernels' checks and times
    alone (the sparse table only; no dense table, search, write path or
    generation), for kernel work on either."""
    import torch

    log("[prep-check] prepare_vectors kernel vs plain on the card")
    check_prep(dev)
    log(f"[prep-time] prepare_vectors at the slab and document shapes "
        f"({card})")
    time_prep(dev)
    torch.cuda.empty_cache()
    sparse, tokens, rng, t_sparse = build_sparse(dev)
    log(f"[tables] sparse {N} docs in {t_sparse:.1f} s")
    texts = [" ".join(f"w{t}" for t in tokens[i])
             for i in rng.integers(0, N, size=BATCH)]
    log("[check] bm25 match kernel vs plain on the card")
    _, args = check_bm25(sparse, texts)
    log(f"[time] bm25 stage 2 at the main-path shape ({card})")
    time_stage2("main path", args)
    log(card)
    return 0


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
            if ("registers" in line or "spill" in line or "entry function"
                    in line or line.startswith("==")):
                log("  " + line.rstrip())
    if sys.argv[1:] == ["--scan"]:
        return scan_only(dev, card)
    if sys.argv[1:] == ["--attn"]:
        return attn_only(dev, card)
    if sys.argv[1:] == ["--match-prep"]:
        return match_prep_only(dev, card)

    from rag_application_tpu_torch.ops import quant as oq

    oq.prepare_vectors_into.launches = 0
    dense, cap, sparse, tokens, rng, t_dense, t_sparse = build_tables(dev)
    table_preps = oq.prepare_vectors_into.launches
    log(f"[tables] dense {N}x{DIM} built in {t_dense:.1f} s, sparse {N} "
        f"docs in {t_sparse:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
        f"prepare_vectors_into launches {table_preps} ({N // PREP_SLAB} "
        f"slabs + the capacity twin)")
    if table_preps != N // PREP_SLAB + 1:
        raise AssertionError(f"build_tables: {table_preps} prep launches")

    log("[check] kernel vs plain on the card")
    q, texts = make_queries(dense, tokens, rng, 1)
    t0 = time.perf_counter()
    scan_errs, n_cases = check_scan(dense, cap, q)
    scan_err = max(scan_errs["fused_scan_int8"], scan_errs["fused_scan"])
    scan_bf_err = scan_errs["fused_scan_bf16"]
    bm25_err, bm25_args = check_bm25(sparse, texts)
    log(f"[check] {n_cases} scan cases + bm25 passed in "
        f"{time.perf_counter() - t0:.1f} s; scan max abs err by kernel "
        f"{scan_errs}")
    del cap

    log(f"[time] kernels at the main-path shapes ({card})")
    scan_t, scan_bf_t, bm25_t = time_kernels(dense, q, bm25_args)
    torch.cuda.empty_cache()

    log(f"[main] FusedSearcher.search, batch {BATCH}, block {BLOCK}, "
        f"q_block {Q_BLOCK} ({card})")
    times, recall, launches, errs = run_main_path(dense, sparse, tokens, rng)
    scan_err = max(scan_err, errs[0])
    scan_bf_err = max(scan_bf_err, errs[1])
    bm25_err = max(bm25_err, errs[2])
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

    log("[prep-check] prepare_vectors kernel vs plain on the card")
    prep_err = check_prep(dev)
    log(f"[prep-time] prepare_vectors at the slab and document shapes "
        f"({card}); build_tables launched it {table_preps} times")
    _, prep_t = time_prep(dev)  # the JSON line keeps the ingest's shape
    torch.cuda.empty_cache()
    log(f"[ingest] Collection.store_document_vectors(Embedder.encode(...)), "
        f"Config() + EncoderConfig() defaults, {INGEST_DOCS} documents x "
        f"{INGEST_CHUNKS} chunks ({card})")
    col, emb, ing_tokens, _, prep_launches = run_ingest(dev)
    log(f"[tokens] hybrid_search_text_batch over {col.dense.size:,} chunks, "
        f"{TOK_BATCHES} batches of {TOK_BATCH} ({card})")
    tok_times, tok_recall, _, tok_launches, errs = run_tokens(
        col, emb, ing_tokens)
    scan_err = max(scan_err, errs[0])
    scan_bf_err = max(scan_bf_err, errs[1])
    bm25_err = max(bm25_err, errs[2])
    if tok_recall < 0.95:
        raise AssertionError(f"tokens wire recall@10 {tok_recall:.4f} < 0.95")
    for name, n in tok_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"tokens wire")
    del col, emb, ing_tokens
    torch.cuda.empty_cache()

    log("[gen-check] decode_attn kernel vs plain on the card")
    attn_err, attn_args = check_decode_attn(dev)
    log(f"[gen-time] decode_attn at the main decode shape and the chat's "
        f"({card})")
    attn_t = time_decode_attn(dev, attn_args)
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
        entry("fused_scan_bf16",
              "rag_application_tpu_torch/csrc/fused_scan_bf16.cu",
              "rag_application_tpu/ops/fused_topk.py:61",
              launches["fused_scan_bf16"], scan_bf_err, scan_bf_t),
        entry("bm25_match", "rag_application_tpu_torch/csrc/bm25_match.cu",
              "rag_application_tpu/ops/bm25.py:45",
              launches["bm25_match"], bm25_err, bm25_t),
        entry("decode_attn", "rag_application_tpu_torch/csrc/decode_attn.cu",
              "rag_application_tpu/ops/decode_attn.py:86", attn_launches,
              attn_err, attn_t),
        entry("prep_vectors", "rag_application_tpu_torch/csrc/prep_vectors.cu",
              "rag_application_tpu/ops/quant.py:66", prep_launches,
              prep_err, prep_t),
    ]}), flush=True)
    log(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
