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
   at seven shapes (a 131,072 x 768 slab, a 64-row document, one row
   with and without dims, 1037 x 100, dims=(), zero and rescaled rows),
   and in place
   (`prepare_vectors_into`) at three row offsets of index-shaped planes
   whose guard rows must stay untouched; `[prep-time]` its kernel (in
   place and into new tensors) and plain times beside its bytes bound,
   at the slab, the document and the two one-row shapes `[pipeline]`
   launches (1 x 768 with dims (64, 128, 256), and with none);
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
7. The serving read path over that collection, as `api/app.py` serves a
   user: `[kg]` a `KGStore(KGConfig(), dim=768)` (the API's width) with
   one page a document, 32 entities from a zipf vocabulary of 16,384
   random two-word names (each mention its name's encoding at cosine
   ~0.95) and 24 relationships from 256 encoded phrases, through
   `upsert_unstructured_page` (pages/s, one prep launch a row, the prep
   kernel bit-equal to plain at d 768, dims () and 1-32 rows, the first
   page's launches held to plain in place), then `deduplicate` (pairs,
   merges, seconds, peak memory); `[orch]` `SearchOrchestrator.execute`
   on 64 queries (a noisy chunk plus 1-3 of its document's entity names,
   a STUB router naming the vocabulary names in the prompt), one at a
   time (p50/p90) and all at once, its hybrid hits equal to
   `Collection.hybrid_search`, `traverse` on the card equal to
   `k_hop_expand` on the CPU, >= 90% of queries with entities and a
   path, every scan and match launch of a pass one at a time held to
   plain at Q 1; `[batcher]` 2,048 concurrent requests through the API's
   `MicroBatcher` (tokens wire, max_batch 256, 2 ms, two groups in
   flight) beside 8 sequential batches of 256, each request equal to its
   group run directly, every scan and match launch of a run held to
   plain, the device's idle share over a profiled run, one run with one
   group in flight beside one with two; `[hybrid]`
   `HybridSearcher.search` on 256 queries (recall@10 against the exact
   oracle over live rows, its BM25 match held to plain); `[checkpoint]`
   `save_collection` / `save_kg` and both loaded on the card (tables
   bit-equal, a tokens batch and the 64 orchestrator queries answered
   the same, bit for bit, their launches held to plain), then a save
   during which another thread deletes a document and inserts one, whose
   snapshot must be the state at capture. Then `[pipeline]`: documents
   through `IngestPipeline` as `api/app.py` wires it (`IngestConfig()`:
   8,000-char chunks, 10 workers, 5 retries; an `ObjectStore` under
   build/; the KG hook, with an extractor stub that draws a page of
   `[kg]`'s shape from `[kg]`'s vocabulary, seeded by the text) into that
   Collection and KGStore: the five non-CSV real fixtures, 32 generated
   text documents of 16 chunks of `[ingest]`'s zipf words, a PDF and a
   docx built here, and one `ingest_url` through a stub fetcher
   (documents/s and chunks/s by kind, encode / store / KG upsert ms a
   chunk task, a profiled document's device busy share, peak memory).
   The failed ledger must be empty, each result's counts those of the
   parsers and the payload table, the prep launches exactly the
   Collection inserts plus the KG rows, the first document's launches
   (1 x 768 with the Collection's dims, and with none for the KG rows)
   bit-equal to plain in place; a re-ingest leaves the chunk count and
   the KG's stats unchanged; the documents again (the generated ones up
   to 16) at `max_concurrency=1` into fresh stores (a fresh embedding
   cache) give the same payloads and bit-equal vectors by (document, page
   or chunk), and the same KG rows by key but where a relationship met on
   several pages of a document keeps another page's profile (its last
   upsert wins); a tokens-wire batch of 256 noisy texts of the new chunks answers with recall@10 >= 0.95,
   its scan and match launches held to plain.
   Then `[ann]`: the IVF engine (`index/ivf.py`) at the repo's ANN
   configuration (docs/ann.md, examples/tune_ivf.py): a 1,000,000 x 768
   DenseIndex (matryoshka dims (128, 256)) of rows around 1,000 N(0, 1)
   centres with 0.25 N(0, 1) noise, made on the card from a seed and
   inserted in 100,000-row chunks; `IVFIndex.build(n_clusters=4096,
   bucket_rows=64, iters=10)` timed by part (k-means, assignment, host
   reorder, slab gather); batches of 256 noisy corpus rows at probes 32,
   64, 128 and 256 (128 candidates rescored): ms a batch and recall@10
   against the exact top-10 over the bf16 plane on 128 queries, which
   must reach 0.95 at probes 32 and not fall by 256; 16 queries at probes
   32 and 128 whose ids and int8-stage scores must equal, bit for bit,
   those of the same index on CPU copies of its tables; peak memory
   above the tables; a save and load that must answer bit for bit. Then
   the API's path over that Collection: `build_ann()` with its defaults
   and 64 single `ann_search(q, limit=10, ef=128)` queries, with and
   without a `document_id` filter (p50/p90), whose hits must equal those
   of the same index on CPU copies (scores within 1e-6). The corpus's
   prep launches are held to plain in the index's planes. Then `[agents]` over the Collection
   and the KGStore (a structured sheet upserted first): every tool of
   `KnowledgeSearchToolbox` once with arguments drawn from the stores (ms
   a tool); 64 `KnowledgeSearchAgent` turns on a STUB router whose
   messages name a tool, with a `VectorMemoryStore` on the card and
   reflections on, one at a time (p50/p90) and then 8 at a time, whose
   messages must be the same; one `DeepResearchAgent` run over the
   toolbox. The memory store's prep launches must be its inserts, the
   first held to plain in place; every scan and match launch of the
   phase (tools, turns, research) is held to plain.
8. `[media]`, the multimodal tower at the repo's widths
   (`init_encoder(EncoderConfig(), multimodal=True)`, random weights from
   seed 0; `Embedder(max_len=128, batch_size=64)`): `[media-check]` the
   card's tower against a CPU copy with the same weights through
   `encode_image` / `encode_audio` on 20 images and 20 clips (a batch of
   16 and a padded tail), alone and with captions, each pooled row within
   cosine MEDIA_COS of the CPU's, and a padded batch's outputs finite;
   4,096 generated 224 x 224 images through `encode_image` and 1,024
   256 x 128 log-mel clips through `encode_audio`, in batches of 64
   (images/s, clips/s, a profiled batch's device busy share), stored as
   albums of 64 into a fresh `Collection(Config())` (one prep launch an
   album, the first two held to plain in place); then 128 PNG, 64
   baseline JPEG, 64 WAV and 16 FLAC files and one MJPEG AVI of 32
   frames, made with the port's own encoders, through `IngestPipeline`
   as `api/app.py` wires it (`IngestConfig()`, a `KGStore` at the API's
   width, no describer), 10 uploads in flight, kind by kind (documents/s
   and chunks/s by kind, encode ms a task, peak memory): every file its
   expected chunks and texts, an empty ledger, prep launches equal to the
   Collection inserts plus the KG's page rows, the first file's held to
   plain; 256 stored images with pixel noise as image queries and 256
   captions as text queries through `hybrid_search_batch`, every scan and
   match launch held to plain, top-10 rows and scores equal to a CPU copy
   of the collection's (saved and loaded) but at near-ties (the share of
   image queries whose own image ranks first); `/v1/embeddings` with PNG
   and JPEG data-URL blocks on `build_app(embedder=...)`, each vector
   equal to a direct `encode_image` call with its caption.
9. Local generation (`[gen-*]`), TinyLlama-1.1B-Chat-v1.0 at its
   published widths with random bf16 weights from a seed, int8 weights
   and int8 KV cache, `attn_kernel=True`:
   `[gen-check]` the int8-KV decode-attention kernel against its plain
   version at ten cache geometries (the main decode shape with fully
   masked leading blocks and a fully masked row, [batch]'s B 8, S 768
   with a batcher's slot map (prompt pads and scattered decode slots
   DEAD) and one free row, B 1 at S 256 and at the
   chat's S 1024, S 288, KVH 8 / hd 128, G 7 and G 16, and K/V bytes
   running through -128..127, once more with one visible slot a row,
   which must match bit for bit); `[gen-time]` its kernel (on a cache
   that stays in L2 and on caches read cold), plain and library times
   beside its bytes bound, at the main decode shape, [batch]'s B 8, S 768
   and the chat's B 1;
   `[gen-main]` `generate` at batch 64, prompt
   896, 128 new tokens (prefill ms, decode ms/step, tokens/s, peak
   memory, the kernel's launch count against the loop's), 4 decode steps
   of the kernel path against the einsum path, a profiled decode step,
   and one `LocalLLM.chat` and one `stream` at B 1 whose texts must be
   equal; then `[batch]`: `LocalLLM.enable_batching(slots=8,
   prompt_pad=256, horizon=512, chunk=64, lookahead=2)` on those weights
   (`serve_vocab`, [SEP]'s LM-head column zeroed so greedy decodes never
   stop early), a 64-token system header through
   `register_prefix_text`, one warm-up chat, then 16 chats of 256-token
   prompts x 128 new tokens at once through `LocalLLM.chat` (tokens/s,
   p50/p90 latency, steps, compactions >= 1, 16 prefix hits, `stats()`,
   peak memory; decode_attn launches equal to 22 x the batcher's steps,
   the first 88 held to plain as they run; 4 requests' tokens
   teacher-forced in one solo forward, each within GEN_LOGIT_ATOL of its
   step's top logit); two concurrent streams equal to two concurrent
   chats (time to the first streamed token); the 16 chats through a
   `spec_k=4` batcher (tokens a step; all 16 teacher-forced); 4 chats
   with [serve]'s finite schema beside 4 plain ones in a
   `sampling_ext=True` batcher (schema-valid, constraint id 1 from the
   bank, no solo call); 4 solo `generate_ids` one at a time (serialized
   tokens/s); one `generate_ids(speculative=True)` at B 1, prompt 512 +
   128 new, beside plain `generate_ids` (teacher-forced).
   Then `[train]`, training and LoRA (models/train.py, models/lora.py):
   `[train-enc]` `make_train_step` on an `EncoderConfig()` encoder (random
   weights from seed 0) with matryoshka dims (64, 128, 256) and AdamW,
   one batch of 64 x 128 tokens from `batches(crop_pairs +
   keyword_pairs)` over 384 generated texts: the first step's loss and
   the projection's weight gradient against a CPU copy, then 20 steps on
   the batch (the loss must fall; step ms, pairs/s, peak memory);
   `[train-lora]` `make_lora_train_step` (r 8, alpha 16 on wq/wk/wv/wo,
   remat) over [gen-main]'s int8 base with kv_quant off, B 8 x T 256 of
   rows that cycle through 16 tokens: the first step's loss at 2 layers
   of the same widths against a CPU copy, then 20 steps that must bring
   the loss below half the first (step ms, tokens/s, peak memory,
   adapter bytes), the base unchanged; then 2 steps of
   `make_lm_train_step` (a full fine-tune, bf16 weights) whose loss must
   fall (step ms, peak memory); `[train-serve]` the trained factors
   through `save_adapters`, `LocalLLM.register_lora` on [gen-main]'s
   weights and flags and `enable_batching` at [batch]'s setting: 4
   conversations each asked with and without the adapter, 8 chats at
   once x 64 new (tokens/s; decode_attn launches 22 x the steps, the
   first 88 held to plain as they run), adapter rows teacher-forced on
   the `lora_merge`d bf16 weights and base rows on the base (each within
   0.25 of its step's top logit), every adapter row's tokens other than
   its base twin's, and the base rows alone on a fresh batcher equal to
   those beside the adapter rows.
10. `[serve]`, the port's HTTP service. Before step 8, the [ingest]
   collection and the [kg] graph are saved as one user space (with an
   account) through `serve.checkpoint_spaces` under build/smoke_serve/.
   Here `build_app(Config(), device=cuda)` with a LOCAL router over
   `LocalLLM` on the [gen-main] weights and flags (a vocabulary with a
   single-byte piece for every printable byte, so response schemas
   compile; SERVE_NEW new tokens where a call names no limit; one
   structured attempt) boots from that directory through
   `serve.restore_spaces` (the users and the account must be the saved
   ones), the search MCP server is attached at /mcp, and an
   `HTTPServer` on port 0 serves in a thread. The standard library's
   client sends `GET /health`, `/v1/models`, `/metrics`; 8
   `/ingest/raw-text` (prep launches equal to the inserts, the first
   document's held to plain in place); 64 `/api/v1/search/hybrid`, 8 at
   once through the space's micro-batcher (each answer equal to
   `Collection.hybrid_search` run directly, scores within 1e-6, other
   hits only at near-ties); 8 `/search/scout`; 4 `/v1/chat/completions`
   with a finite `response_format` schema (parsed and schema-valid, its
   constraint compiled); 4 `/api/v1/query/ask`; 2 streamed
   `/chat/completions` (non-empty); `/v1/embeddings` on 8 texts (equal to
   `Embedder.encode`); `/admin/checkpoint` then `/admin/restore` under a
   new user id (answers equal); the MCP server listed and called over
   HTTP and through `MCPClient.add_inprocess` (equal). Every scan, match
   and prep launch is held to plain, the first SERVE_ATTN_CHECKS decode
   attention launches as they happen. Then `python -m
   rag_application_tpu_torch.serve` (STUB provider) boots from the same
   directory as its own process: seconds until `/health` answers, its
   users and chunk count the saved ones, a hybrid search equal to the
   in-process answer before the ingests; then it is stopped. Prints
   p50/p90 ms and launches per route, searches/s, generated tokens/s,
   boot and restore seconds and peak memory.

11. `[shard]`, corpus-axis sharding (`parallel/*`), after `[agents]`: a
   mesh of 4 shards, each on this card (`make_mesh(4, devices=[cuda:0]
   * 4)`). Slice A's tables (step 3) cut with `shard_corpus` (the dense
   planes as views) and `build_sharded_sparse`, then
   `sharded_fused_hybrid` with the main path's funnel as a spec (the
   cascade, int8, BM25; each shard the plain blocked scan) on 3 batches
   of 1,024 noisy rows (cut from 8,192 for time) against one
   `fused_core` call on the whole tables with the same spec: each row's
   ids equal with scores within 1e-5, or, in at most 5% of the rows,
   no worse where the shards' wider candidate lists found a true
   neighbour the one-device call missed (each such score held to the
   exact dense score of its id); recall@10 >= 0.95 against the exact
   oracle on 128 queries; exactly 4 BM25 match launches a batch, each
   held to plain (ms a batch, peak memory). Then `ShardedKGSearch` over
   [kg]'s store on 64 queries, bf16 (hits equal to
   `KGStore.search_across_spaces` but at near-ties) and capacity mode
   (hits equal to the same capacity-mode search on a CPU mesh but at
   near-ties; its overlap with the bf16 top-10 printed);
   then `build_sharded_ivf` over [ann]'s corpus at [ann]'s settings,
   `sharded_ivf_search` on a batch of 256 at probes 32 and 128 a shard
   (recall@10 >= 0.95 at 32), 64 queries held to the same partitions on
   a CPU mesh (int8 stage bit for bit, rescored ids but at near-ties);
   then `sharded_topk_dryrun` and `sharded_kg_dryrun` on the mesh.
12. `[evals]`, after `[media]`: `evals/real_docs.py` at `Config()`
   widths over the fixtures (Pokemon.csv only where pandas is
   installed): `build_real_docs_stack` on the card (the first document's
   prep, scan and match launches held to plain as it is ingested),
   `evaluate_real_docs` on all 28 questions (the first question's
   launches held to plain), the same stack as a CPU copy with the card's
   weights and scan engine whose per-question flags must equal the
   card's but at near-ties, then the stack with `train_steps=300` and
   its gates (chunks, ingest s, recall@5, answer hit rate, the gates'
   messages); then `evals/multimodal.py`: the first 2 losses of
   `train_multimodal` against a CPU copy, and `evaluate_multimodal` (300
   steps) with the nine recalls at 1, 5 and 10 held to the reference
   test's floors (4x chance t->i and t->a, 2x i->a, at 5).

Prints one `{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Exits non-zero on any failure, and
when CUDA is not available.

    python3 chip_smoke.py --scan

runs steps 1-2, the dense tables of step 3 and the scan's part of step 4
alone (its checks and its times), for kernel work on the scan.

    python3 chip_smoke.py --attn

runs steps 1-2 and then `[gen-check]` and `[gen-time]` of step 9 alone,
for kernel work on the decode attention.

    python3 chip_smoke.py --batch

runs steps 1-2, `[gen-check]` and `[gen-time]`, then `[batch]` of step 9
alone (building the [gen-main] weights), for work on the continuous
batcher or speculation.

    python3 chip_smoke.py --train

runs steps 1-2 and then `[train]` of step 9 alone (building the
[gen-main] weights), for work on training, LoRA or multi-LoRA serving.

    python3 chip_smoke.py --match-prep

runs steps 1-2, `[prep-check]` and `[prep-time]` of step 6, then the
sparse table of step 3 and the BM25 match's checks and stage-2 times of
step 4 alone, for kernel work on either kernel.

    python3 chip_smoke.py --read-path

runs steps 1-2, `[ingest]` and `[tokens]` of step 6 and step 7 alone,
for work on the serving read path.

    python3 chip_smoke.py --pipeline

runs steps 1-2, `[ingest]` of step 6 and `[pipeline]` of step 7 alone,
into `[ingest]`'s collection and a new KGStore at the API's width, for
work on the ingest pipeline.

    python3 chip_smoke.py --serve

runs steps 1-2, `[ingest]` of step 6 and `[kg]` of step 7, then step 10
alone (building the [gen-main] weights), for work on the HTTP service.

    python3 chip_smoke.py --media

runs steps 1-2 and then step 8 alone, for work on the multimodal tower
and the media front ends.

    python3 chip_smoke.py --ann
    python3 chip_smoke.py --agents

run steps 1-2 and `[ingest]` of step 6, then `[ann]` of step 7 alone,
or `[kg]` and `[agents]` of step 7, for work on the ANN engine or the
agent layer.

    python3 chip_smoke.py --evals
    python3 chip_smoke.py --shard

run steps 1-2 and then step 12 alone, or the tables of step 3,
`[ingest]` and `[kg]`, then step 11 alone, for work on the evals or on
corpus-axis sharding.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

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
INSERT_REPS = 200     # one document's DenseIndex.insert under the profiler
# host idle at each end of a profiler window: torch.profiler missed launches
# near the edges of short windows (0.45 of 20 inserts' in one H100 run)
PROFILE_MARGIN_S = 0.02
TOK_BATCHES, TOK_BATCH = 8, 256  # the API micro-batcher's default batch
TOK_FLIP = 0.2        # share of a query's words resampled (bench.py)

# the serving read path over the [ingest] collection: a KGStore at the
# API's width (KGStore(KGConfig(), dim=min(embedder.dim, 2048)), as
# api/app.py builds it beside each user's Collection), one page a
# document; the orchestrator, the API's micro-batcher, the staged funnel
# and checkpoints of both stores
KG_NAMES, KG_ENTS, KG_RELS, KG_PHRASES = 16384, 32, 24, 256
KG_COS = 0.95         # a mention's cosine to its name's vector
ORCH_QUERIES = 64
BATCHER_REQS, BATCHER_MAX = 2048, 256  # api/app.py: max_batch 256, 2 ms
HYB_QUERIES = 256
CKPT_DIR = "build/smoke_checkpoints"

# [pipeline]: documents through IngestPipeline (IngestConfig() defaults, an
# ObjectStore under build/) into the read path's Collection and KGStore:
# the real non-CSV fixtures, PIPE_DOCS generated text documents of
# PIPE_CHUNKS 8,000-char chunks of [ingest]'s zipf words, a PDF and a docx
# built here, and one URL through a stub fetcher
PIPE_REAL = ("Resume.pdf", "ragas_papers.pdf", "cube.PDF",
             "Vivek Malipatel - Resume.docx", "Intro To ML - Slide.pptx")
# 32 generated documents, not 128 or 64: at 128 the whole run took 725 s
# of its 1,200 (the pipeline 425 of them), and at 64 with [serve] ~640 s
# (the pipeline 184 of them), over half its limit
PIPE_DOCS, PIPE_CHUNKS = 32, 16
PIPE_SERIAL_DOCS = 16  # generated documents again at max_concurrency=1
PIPE_URL = "https://docs.example.com/guides/retrieval"
PIPE_OBJECTS = "build/smoke_objects"

# [ann]: the repo's own ANN configuration (docs/ann.md,
# examples/tune_ivf.py, bench.py's ANN leg): 1,000,000 x 768 rows, each
# one of 1,000 N(0, 1) centres plus 0.25 N(0, 1), in a DenseIndex with
# matryoshka dims (128, 256); IVF with 4,096 clusters, 64-row buckets, 10
# k-means iterations; batches of 256 noisy corpus rows, probes 32-256 with
# 128 candidates rescored. Then the API's path (`/admin/build-ann` calls
# `build_ann()` with its defaults, `/api/v1/search/ann` one query with ef
# 128) over the [ingest] collection.
ANN_N, ANN_TRUE, ANN_NOISE, ANN_CHUNK = 1_000_000, 1000, 0.25, 100_000
ANN_CLUSTERS, ANN_BUCKET, ANN_ITERS = 4096, 64, 10
ANN_BATCH, ANN_PROBES, ANN_RESCORE = 256, (32, 64, 128, 256), 128
ANN_SEED, ANN_CPU_QUERIES = 11, 16
ANN_API_QUERIES, ANN_API_EF = 64, 128
ANN_FILE = "build/smoke_ann/ivf.npz"

# [agents]: the knowledge toolbox over the [ingest] collection and the
# [kg] graph, KnowledgeSearchAgent turns on a STUB router whose messages
# name a tool ("use <tool> <text>"), memories on the card, reflections on
AGENT_TURNS, AGENT_CONCURRENCY = 64, 8
AGENT_TOOLS = ("hybrid_search", "search_entities_semantic",
               "search_across_spaces", "search_pages_semantic",
               "search_relationships_semantic", "search_documents")
AGENT_SHEET = "people.csv"

# [media]: the multimodal tower at the repo's widths (EncoderConfig(),
# init_encoder(multimodal=True), random weights from seed 0), Embedder(
# max_len=128, batch_size=64): 224 x 224 images (28 x 28 blocks of 8 x 8
# pixels, `media_images`) captioned with MEDIA_CAPTION zipf words for the
# BM25 leg, 256 x 128 log-mel clips; stored as albums of 64 into a
# Collection(Config()); then media
# files through IngestPipeline (IngestConfig(), a KGStore at the API's
# width, no describer), searches and /v1/embeddings
MEDIA_SIZE = 224
MEDIA_IMAGES, MEDIA_CLIPS, MEDIA_BATCH = 4096, 1024, EMB_BATCH
MEDIA_CAPTION = 12
# [media-check]: one full batch of 16 and a padded tail (the CPU copy
# runs batches of 4: it takes ~40 s for 4 x 128 rows on that host)
MEDIA_CHECK_N, MEDIA_CHECK_BATCH = 20, 16
# a pooled row's cosine to the CPU copy's: a relative L2 gap of <= 0.045,
# ~23 bf16 unit roundoffs (2^-9), which the card and the CPU place at other
# points over six layers (the patch products, softmax, gelu, residual
# adds); tests/test_torch_{encoder,multimodal}.py hold bf16 to the same
MEDIA_COS = 0.999
MEDIA_HELD = 2        # albums whose prep launches are held to plain
MEDIA_PNG, MEDIA_JPEG, MEDIA_WAV, MEDIA_FLAC = 128, 64, 64, 16
MEDIA_FRAMES = 32     # one MJPEG AVI
MEDIA_QUERIES = 256
MEDIA_NOISE = 4 / 255  # image queries: stored images +- this, clipped

# [serve]: the port's HTTP service (api/app.py's build_app, serve.py's
# restore_spaces) over the [ingest] collection and the [kg] graph saved as
# one user space, a LOCAL router at [gen-main]'s widths and weights, every
# route by the standard library's client; then `python -m
# rag_application_tpu_torch.serve` from the same directory
SERVE_DIR = "build/smoke_serve"
SERVE_INGESTS, SERVE_SEARCHES, SERVE_CONCURRENCY = 8, 64, 8
SERVE_SCOUTS, SERVE_CHATS, SERVE_ASKS, SERVE_STREAMS = 8, 4, 4, 2
SERVE_EMBED = 8
# a finite grammar: every path through it ends, so a random model's
# constrained decode reaches an accepting state
SERVE_SCHEMA = {"type": "object", "properties": {
    "kind": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}
SERVE_SCHEMA_NEW = 48  # bytes of its longest sentence, 28, and eos
SERVE_NEW = 24        # new tokens where a call names no limit
SERVE_ATTN_CHECKS = 88  # decode_attn launches held to plain (4 steps x 22)
SERVE_BOOT_S = 300

# [batch]: continuous batching through LocalLLM.enable_batching at the
# repo's documented batcher setting (docs/decoder.md, examples/
# tune_batcher.py): 16 chats of 256-token prompts sharing a 64-token
# system header, 128 new tokens each, 8 slots, horizon 512, chunks of 64,
# lookahead 2, on [gen-main]'s weights and flags
BATCH_SLOTS, BATCH_PROMPT, BATCH_HORIZON = 8, 256, 512
BATCH_CHUNK, BATCH_LOOKAHEAD = 64, 2
BATCH_REQS, BATCH_NEW, BATCH_HEADER = 16, 128, 64
BATCH_CHECKED = 4        # requests teacher-forced against one solo forward
BATCH_ATTN_CHECKS = 88   # decode_attn launches held to plain (4 steps x 22)
BATCH_STREAM_NEW = 64    # new tokens of the two streams and their chats
BATCH_SPEC_K = 4
BATCH_EXT = 4            # constrained chats (and as many plain) in one batch
BATCH_SOLO = 4           # solo generate_ids runs, one at a time
BATCH_SOLO_PROMPT = 512  # solo speculation at B 1
# [batch]'s decode-step attention: (B, S, KVH, G, hd), S = 256 + 512
BATCH_ATTN = (BATCH_SLOTS, BATCH_PROMPT + BATCH_HORIZON, 4, 8, 64)

# [train]: training and LoRA (models/train.py, models/lora.py).
# [train-enc]: contrastive steps on an EncoderConfig() encoder over
# batches(crop_pairs + keyword_pairs) of generated texts
TRAIN_TEXTS, TRAIN_WORDS = 384, 48  # texts, and words a text
TRAIN_BATCH, TRAIN_LEN = 64, 128
TRAIN_DIMS = (64, 128, 256)         # IndexConfig().matryoshka_dims
TRAIN_STEPS = 20
TRAIN_ENC_LR = 1e-4
# card vs its CPU copy on the first step (bf16 activations, f32 weights):
# loss relative error, and the relative L2 error of the projection's
# weight gradient, about 8x and 5x the measured 6.64e-5 and 3.97e-3
# (H100 80GB HBM3 at 700 W)
TRAIN_ENC_LOSS_RTOL, TRAIN_ENC_GRAD_RTOL = 5e-4, 2e-2
# [train-lora]: rank-8 adapters (alpha 16) on wq/wk/wv/wo over [gen-main]'s
# int8 base with an f32 KV-free training forward, B 8 x T 256, remat
LORA_R, LORA_ALPHA, LORA_B, LORA_T = 8, 16.0, 8, 256
LORA_PERIOD = 16        # each row cycles through 16 tokens of its own
LORA_LR = 1e-3          # at 1e-2 the 22-layer run diverged
LORA_DROP = 0.5         # the 20th step's loss below half the first's
LORA_CHECK_LAYERS = 2   # the CPU copy: the same widths at 2 layers
LORA_CHECK_STEPS = 2    # the card held to the CPU copy on 2 steps
# card vs CPU copy, each checked step: the loss's relative error and the
# worst adapter factor's gradient, relative L2, about 10x and 5x the
# measured 9.30e-6 and 3.98e-3 (H100 80GB HBM3 at 700 W)
LORA_LOSS_RTOL, LORA_GRAD_RTOL = 1e-4, 2e-2
FT_STEPS, FT_LR = 2, 1e-4  # full fine-tune, bf16 weights
# [train-serve]: the trained adapter beside the base in one batch
TSERVE_CONVS, TSERVE_NEW = 4, 64  # conversations, each asked twice
TSERVE_DIR = "build/smoke_lora"

# [evals]: evals/real_docs.py over the fixtures at Config() widths, graded
# on every question untrained and after EVAL_TRAIN_STEPS (bench.py:918's
# default); then evals/multimodal.py at its defaults (MM_STEPS, recalls at
# MM_KS). Pokemon.csv needs pandas, which a host may lack: without it the
# stack takes the other five fixtures.
EVAL_TRAIN_STEPS, EVAL_K = 300, 5
# a per-question flag of the card may differ from its CPU copy's only
# where the two hybrid rankings differ at a near-tie: the card scores the
# CPU's pick at the first differing rank within EVAL_TIE of its own (dbsf
# scores lie in [0, 2]; the bf16 encoder rounds apart on the two devices)
EVAL_TIE = 2e-2
MM_STEPS, MM_KS, MM_CHECK_STEPS = 300, (1, 5, 10), 2
# card vs CPU copy, each checked step's loss (f32 tower), relative
MM_LOSS_RTOL = 1e-4
# [shard]: corpus-axis sharding (parallel/*) over a mesh of SHARDS shards,
# each on this card: slice A's tables, SHARD_BATCH queries a batch (cut
# from BATCH for time: each shard's plain blocked scan sorts whole blocks)
SHARDS, SHARD_BATCH, SHARD_BATCHES = 4, 1024, 2
SHARD_ATOL = 1e-5       # scores of equal ids, sharded vs one device
SHARD_UNEQUAL = 0.05    # the share of rows that may differ from one device's
SHARD_KG_QUERIES = 64
SHARD_IVF_CPU = 64      # queries held to a CPU copy of the sharded IVF


def log(msg: str) -> None:
    print(msg, flush=True)


def zipf_probs(n):
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def synth_tokens(rng, n, vocab=VOCAB, doc_len=DOC_LEN):
    """Zipfian bag-of-words docs, as a token-id matrix (bench.py's)."""
    return rng.choice(vocab, size=(n, doc_len), p=zipf_probs(vocab))


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


def exact_top_ids(dense, q, k, live_only=False):
    """Brute-force exact top-k of bf16-rounded normalized queries over the
    bf16 plane, in full f32 products; with ``live_only``, over the rows
    not deleted."""
    import torch

    from rag_application_tpu_torch.ops.topk import stable_topk
    from rag_application_tpu_torch.utils import full_f32_matmul

    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    qb = qn.to(torch.bfloat16).float()
    best_v = best_i = None
    with full_f32_matmul():
        for s in range(0, dense.size, 131072):
            sc = qb @ dense.vecs[s:s + 131072].float().T
            if live_only:
                sc = torch.where(dense.live[s:s + sc.shape[1]], sc,
                                 float("-inf"))
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
    rows of sentinels only, at pool 24, at T 5 with invalid slots, at
    L 8, and at L 1024 and 1001 (long documents: rows matched in chunks,
    the second with 4-byte copies and a ragged last chunk); the
    gathered-rows entry `bm25_match_scores` bit-equal to its
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
    t1024, t1001 = table(2000, 1024), table(2000, 1001)
    cases = [("main-path candidates", doc_packed, cand, q_terms, q_valid),
             ("rows all sentinel", doc_packed,
              torch.full_like(cand[:256], n_docs), q_terms[:256],
              q_valid[:256]),
             ("pool 24", t32, ids(1000, 24, 5000), *queries(1000, 32)),
             ("T 5 with invalid slots", t32, ids(1000, 16, 5000),
              *queries(1000, 5)),
             ("L 8", t8, ids(1000, 16, 5000), *queries(1000, 32)),
             ("L 1024", t1024, ids(1000, 16, 2000), *queries(1000, 32)),
             ("L 1001", t1001, ids(300, 24, 2000), *queries(300, 5))]
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


class _Recorder:
    """A kernel wrapper's stand-in that records its calls; the launches
    the wrapper counts on its module-level name (this object) land on the
    wrapper's own count."""

    def __init__(self, fn, counts):
        self.fn, self.counts, self.calls = fn, counts or {}, []

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        before = dict(self.counts)
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out, rose(self.counts, before)))
        return out


@contextlib.contextmanager
def recording(module, name, counts=None):
    """While the block runs, record ``(args, kwargs, result, took)`` of
    every call of the kernel wrapper ``module.name`` (the wrapper still
    runs and counts its launches as it does outside the block); ``took``
    lists the keys of ``counts``, the wrapper's launch counts by kernel,
    that rose during the call."""
    rec = _Recorder(getattr(module, name), counts)
    with mock.patch.object(module, name, rec):
        yield rec.calls


def routed(scans):
    """Recorded scans with the kernel each took asked of `scan_route`
    (where two threads launch at once, a launch count can rise under the
    other thread's call)."""
    from rag_application_tpu_torch.ops import fused_topk as ft

    return [(a, kw, o, [ft.scan_route(a[0].dtype, a[1].dtype, a[0].shape[1],
                                      a[0].stride(0), a[0].data_ptr(),
                                      a[1].contiguous().data_ptr())])
            for a, kw, o, _ in scans]


def check_recorded(label, scans, matches, each=True):
    """Each recorded `scan_sheet` and `bm25_match_rows` launch of a path,
    against the plain version on the same inputs: int8 sheets bit-equal;
    f32 sheets within 2 d 2^-24 (each side within d 2^-24 of the exact
    dot of unit prefixes) with other ids only at near-ties; BM25
    bit-equal. Every int8 scan must have taken the int8 tensor-core
    kernel and every bf16 scan the bf16 one. Logs a line a scan, or with
    ``each`` False one line for all. Returns (max abs err of the int8
    scans, of the bf16 scans, of the BM25 matches)."""
    import torch

    from rag_application_tpu_torch.ops import fused_topk as ft

    kinds = {args[0].dtype for args, _, _, _ in scans}
    if kinds != {torch.int8, torch.bfloat16} or not matches:
        raise AssertionError(f"{label}: recorded scans {kinds} and "
                             f"{len(matches)} bm25 matches")
    want = {torch.int8: "fused_scan_int8", torch.bfloat16: "fused_scan_bf16"}
    scan_err = dict.fromkeys(want, 0.0)
    n_scans, n_mism = dict.fromkeys(want, 0), 0
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
        if each:
            log("  " + line)
        if not ok:
            raise AssertionError(f"scan kernel != plain: {line}")
        n_scans[c.dtype] += 1
        n_mism += mism
    if not each:
        log(f"  {label}: {n_scans[torch.int8]} int8 scans bit-equal to plain, "
            f"{n_scans[torch.bfloat16]} bf16 scans within 2 d 2^-24 (max abs "
            f"err {scan_err[torch.bfloat16]:.3g}, {n_mism} ids other than "
            f"plain's, each at a near-tie)")
    return (scan_err[torch.int8], scan_err[torch.bfloat16],
            check_matches(label, matches))


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
            # idle margins, so that no launch lies at an edge of the window
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
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
    kernel's order): the fresh-tensor entry `prepare_vectors` at seven
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
             (f"1 x {DIM}", 1, DIM, (), False),
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
    """Kernel and plain ms at the slab, the document and the two one-row
    shapes, beside the bytes bound (the function moves 4d bytes in and
    3d + 4M + 1 out per row, M prefix dims). The kernel is timed as
    `DenseIndex.insert` launches it, in place into an index's planes
    (rows 1000 on below the slab), and beside it through the fresh-tensor
    entry. The times are device times from the profiler; below the slab
    CUDA events around back-to-back calls measure the host's enqueue rate
    instead, which is logged beside them. Returns (ms, plain_ms, None,
    bound_ms, bound_by) for each: the slab, the document (the shape
    `[ingest]` launches), then one row with the Collection's dims and one
    with none (the shapes `[pipeline]` launches: a chunk, a KG row)."""
    import torch

    from rag_application_tpu_torch.ops import quant as oq

    def prep_ms(times):
        ms, n = next((v for k, v in times.items() if "prep_vectors_" in k),
                     (0.0, 0.0))
        if round(n) != 1:
            raise AssertionError(f"expected one prep launch a call, saw {n}")
        return ms

    out = []
    for n, start, reps, dims in ((PREP_SLAB, 0, 20, PREP_DIMS),
                                 (EMB_BATCH, 1000, 200, PREP_DIMS),
                                 (1, 1000, 200, PREP_DIMS),
                                 (1, 1000, 200, ())):
        x = prep_inputs(dev, n, DIM, 40)
        cap = start + n
        planes = (torch.zeros((cap, DIM), dtype=torch.bfloat16, device=dev),
                  torch.zeros((cap, DIM), dtype=torch.int8, device=dev),
                  torch.zeros((cap, len(dims)), device=dev),
                  torch.zeros((cap,), dtype=torch.bool, device=dev))
        run = lambda: oq.prepare_vectors_into(  # noqa: E731
            x, dims, *planes, start)
        fresh = lambda: oq.prepare_vectors(x, dims)  # noqa: E731
        plain = lambda: oq.prepare_vectors_plain(x, dims)  # noqa: E731
        ms = prep_ms(kernel_times(run, reps))
        fresh_ms = prep_ms(kernel_times(fresh, reps))
        plain_ms = device_ms(plain, max(5, reps // 10))
        paced = cuda_ms(run, reps=reps)
        paced_plain = cuda_ms(plain, reps=max(5, reps // 10))
        nbytes = n * DIM * 4 + n * DIM * 3 + n * len(dims) * 4 + n
        ops = n * DIM * (8 + len(dims))
        bound = max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= ops / F32_OPS_S \
            else "operations"
        log(f"  prep_vectors {n} x {DIM}, dims {dims}: kernel in place "
            f"{ms:.5f} ms (into new tensors {fresh_ms:.5f}), plain "
            f"{plain_ms:.5f} ms (device time, profiler); back-to-back calls "
            f"by CUDA events: kernel {paced:.5f} ms, plain {paced_plain:.5f}"
            f" ms; bound {bound:.3g} ms ({by}: {nbytes:,} B), no library "
            f"call")
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
    prepare_vectors_into launches, chunks/s)."""
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
    # and one prep launch, which writes the planes and the live flags.
    # The wrapper's count says how many prep launches an insert makes; the
    # profiler says which kernels ran. Its counts only bound: it misses
    # launches of a short window (0.45 of 20 inserts' in one run). The
    # capacity holds every insert, so that no growth copies run
    cfg = dataclasses.replace(
        Config().index,
        initial_capacity=(2 + 2 * INSERT_REPS) * vecs.shape[0])
    idx = DenseIndex(cfg, device=dev)
    idx.insert(vecs)
    inserts = []

    def insert():
        inserts.append(1)
        idx.insert(vecs)

    oq.prepare_vectors_into.launches = 0
    times = kernel_times(insert, INSERT_REPS)
    preps = oq.prepare_vectors_into.launches
    kernels = {k: n for k, (_, n) in times.items()
               if not k.startswith("Memcpy")}
    log(f"  DenseIndex.insert of one document ({vecs.shape[0]} x "
        f"{vecs.shape[1]}, Config().index but its capacity): {preps} prep "
        f"launches in "
        f"{len(inserts)} inserts (the wrapper's count); device operations "
        f"an insert as the profiler saw them over {INSERT_REPS}: "
        f"{ {k[:60]: round(n, 3) for k, (_, n) in times.items()} }")
    if preps != len(inserts) or len(kernels) != 1 \
            or "prep_vectors_" not in next(iter(kernels)) \
            or next(iter(kernels.values())) > 1:
        raise AssertionError(f"{len(inserts)} DenseIndex.insert calls made "
                             f"{preps} prep launches and ran {kernels}, not "
                             f"one prep launch each and no other kernel")
    return col, emb, tokens, texts, launches, timed / total_s


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


def check_matches(label, matches):
    """Each recorded `bm25_match_rows` launch against the plain version
    on the same inputs, bit for bit. Returns the max abs error."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob

    worst = 0.0
    for args, _, out, _ in matches:
        plain = ob.bm25_match_rows_plain(*args)
        worst = max(worst, (out - plain).abs().max().item())
        if not torch.equal(out, plain):
            raise AssertionError(f"bm25 match kernel != plain: {label}, rows "
                                 f"{tuple(args[1].shape)}")
    log(f"  {label}: {len(matches)} bm25 match launches bit-equal to plain")
    return worst


def check_kg_prep(dev):
    """The prep kernel against its plain version at the KG's shape (d 768,
    no matryoshka dims, 1-32 rows an insert): into new tensors, and in
    place into a KG space's planes between guard rows. Returns the worst
    max abs error of the bf16 plane."""
    import torch

    from rag_application_tpu_torch.ops import quant as oq

    worst, cap = 0.0, 1024
    gen = torch.Generator(device=dev).manual_seed(13)
    for i, n in enumerate((1, 2, 5, 17, 32)):
        x = prep_inputs(dev, n, DIM, 90 + i, special=n > 2)
        kern = oq.prepare_vectors(x, ())
        plain = oq.prepare_vectors_plain(x, ())
        planes = [
            torch.randint(-2**15, 2**15, (cap, DIM), generator=gen,
                          device=dev, dtype=torch.int16).view(torch.bfloat16),
            torch.randint(-128, 128, (cap, DIM), generator=gen, device=dev,
                          dtype=torch.int8),
            torch.zeros((cap, 0), device=dev),
            torch.zeros((cap,), dtype=torch.bool, device=dev)]
        before = [p.clone() for p in planes]
        start = 500 + 7 * i
        oq.prepare_vectors_into(x, (), *planes, start)
        torch.cuda.synchronize()
        end = start + n
        fresh = [torch.equal(a.view(torch.int16), b.view(torch.int16))
                 if a.dtype == torch.bfloat16 else torch.equal(a, b)
                 for a, b in zip(kern, plain)]
        rows = [torch.equal(planes[0][start:end].view(torch.int16),
                            plain[0].view(torch.int16)),
                torch.equal(planes[1][start:end], plain[1]),
                bool(planes[3][start:end].all().item())]
        guards = all(torch.equal(p[:start].view(torch.uint8),
                                 b[:start].view(torch.uint8))
                     and torch.equal(p[end:].view(torch.uint8),
                                     b[end:].view(torch.uint8))
                     for p, b in zip(planes, before) if p.shape[1:] != (0,))
        err = (kern[0].float() - plain[0].float()).abs().max().item()
        worst = max(worst, err)
        log(f"  prep {n} x {DIM}, dims (): new tensors bit-equal {fresh}; in "
            f"place at row {start}: vecs / int8 / live {rows}, guard rows "
            f"untouched {guards}")
        if not (all(fresh) and all(rows) and guards):
            raise AssertionError(f"prep kernel != plain at the KG shape, "
                                 f"{n} rows")
    return worst


def kg_vocab(rng):
    """KG_NAMES entity names (two words of 4-8 random letters), a type
    each, and KG_PHRASES relation phrases."""
    from rag_application_tpu_torch.kg.extract import ENTITY_TYPES

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def word():
        return "".join(rng.choice(letters, int(rng.integers(4, 9))))

    names, seen = [], set()
    while len(names) < KG_NAMES:
        name = f"{word()} {word()}"
        if name not in seen:
            seen.add(name)
            names.append(name)
    types = [ENTITY_TYPES[i] for i in rng.integers(0, len(ENTITY_TYPES),
                                                   KG_NAMES)]
    phrases = [f"{word()} {word()} {word()}" for _ in range(KG_PHRASES)]
    return names, types, phrases


def kg_page(rng, names, types, phrases, zipf):
    """One page's extraction as the KG extractor returns it: KG_ENTS
    distinct entities drawn by ``zipf`` over the names and KG_RELS
    distinct (source, target, type) relationships between them, each
    profiled by one of the phrases. Returns (name indices, phrase
    indices, {"entities", "relationships"})."""
    from rag_application_tpu_torch.kg.extract import RELATION_TYPES, slugify

    idx = rng.choice(KG_NAMES, KG_ENTS, replace=False, p=zipf)
    ents = [{"id": slugify(names[j]), "text": names[j],
             "entity_type": types[j],
             "entity_profile": f"{names[j]} profile"} for j in idx]
    rels, keys, ph = [], set(), []
    while len(rels) < KG_RELS:
        a, b = rng.choice(KG_ENTS, 2, replace=False)
        t = int(rng.integers(len(RELATION_TYPES)))
        if (a, b, t) in keys:
            continue
        keys.add((a, b, t))
        ph.append(int(rng.integers(KG_PHRASES)))
        rels.append({"source": ents[a]["id"], "target": ents[b]["id"],
                     "relation_type": RELATION_TYPES[t],
                     "relationship_profile": phrases[ph[-1]]})
    return idx, ph, {"entities": ents, "relationships": rels}


def near(rng, base):
    """Unit rows at cosine ~KG_COS to the unit rows of ``base``."""
    sigma = np.sqrt(1.0 / KG_COS ** 2 - 1.0) / np.sqrt(base.shape[1])
    v = base + sigma * rng.standard_normal(base.shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def run_kg(col, emb, texts, dev):
    """[kg]: one page a document written through
    `KGStore.upsert_unstructured_page` (KG_ENTS entities from a zipf
    vocabulary of KG_NAMES names, each mention its name's encoding at
    cosine ~KG_COS; KG_RELS relationships from KG_PHRASES encoded
    phrases), then `deduplicate` once. Returns (kg, names, the names of
    each document's page, the prep kernel's worst error)."""
    import torch

    from rag_application_tpu_torch.config import KGConfig
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.kg import dedup as dd
    from rag_application_tpu_torch.kg.store import KGStore, Space
    from rag_application_tpu_torch.ops import quant as oq

    prep_err = check_kg_prep(dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    names, types, phrases = kg_vocab(rng)
    name_vecs = emb.encode(names)
    phrase_vecs = emb.encode(phrases)
    zipf = zipf_probs(KG_NAMES)
    # a page's embedding: the mean of its document's chunk rows
    vecs = col.dense.vecs
    page_vecs = torch.cat([
        vecs[s * INGEST_CHUNKS:(s + 512) * INGEST_CHUNKS].view(
            -1, INGEST_CHUNKS, DIM).float().mean(1)
        for s in range(0, INGEST_DOCS, 512)]).cpu().numpy()
    kg = KGStore(KGConfig(), dim=min(emb.dim, 2048), device=dev)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: {KG_NAMES} names and "
        f"{KG_PHRASES} relation phrases encoded; KGStore(KGConfig(), dim "
        f"{kg.dim}), max_degree {kg.cfg.max_degree}, max_hops "
        f"{kg.cfg.max_hops}")

    def page(i):
        idx, ph, found = kg_page(rng, names, types, phrases, zipf)
        rel_vecs = near(rng, phrase_vecs[ph])
        return [names[j] for j in idx], dict(
            content=texts[i * INGEST_CHUNKS], embedding=page_vecs[i],
            **found, entity_embeddings=near(rng, name_vecs[idx]),
            relationship_embeddings=rel_vecs)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    oq.prepare_vectors_into.launches = 0
    page_names, upsert_s = [], 0.0
    for i in range(INGEST_DOCS):
        ents, kw = page(i)
        page_names.append(ents)
        t0 = time.perf_counter()
        if i == 0:  # the first page's launches, held against plain
            with recording(idense, "prepare_vectors_into") as preps:
                kg.upsert_unstructured_page(f"doc-{i}", 1, **kw)
        else:
            kg.upsert_unstructured_page(f"doc-{i}", 1, **kw)
        upsert_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = oq.prepare_vectors_into.launches
    stats = kg.stats()
    want = INGEST_DOCS * (1 + KG_ENTS + KG_RELS)
    log(f"  {INGEST_DOCS} pages upserted in {upsert_s:.2f} s -> "
        f"{INGEST_DOCS / upsert_s:,.1f} pages/s ({want / upsert_s:,.0f} rows"
        f"/s); stats {stats}; prepare_vectors_into launches {launches} (one "
        f"a row: {want}); device memory {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB (the KG {(torch.cuda.memory_allocated() - base) / 2**30:.2f}"
        f" GiB)")
    if launches != want or stats["entity"] != INGEST_DOCS * KG_ENTS \
            or stats["relationship"] != INGEST_DOCS * KG_RELS:
        raise AssertionError(f"[kg] launches {launches}, stats {stats}")
    if check_preps("[kg] the first page", preps) != {(1, ()): len(preps)}:
        raise AssertionError("[kg] the first page's prep launches are not "
                             "one row each with no dims")

    # dedup: the self-kNN over every entity row, then the merges
    found = {}
    real_find = dd.find_duplicates

    def find(*a, **k):
        t0 = time.perf_counter()
        pairs = real_find(*a, **k)
        found["s"] = time.perf_counter() - t0
        table = kg.spaces[Space.ENTITY]
        found["pairs"] = len(pairs)
        found["same"] = sum(table.get(x)["text"] == table.get(y)["text"]
                            for x, y, _ in pairs)
        return pairs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dd.find_duplicates = find
    try:
        t0 = time.perf_counter()
        merged = dd.deduplicate(kg)
        torch.cuda.synchronize()
        dedup_s = time.perf_counter() - t0
    finally:
        dd.find_duplicates = real_find
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    after = kg.stats()
    log(f"  deduplicate: {found['pairs']:,} pairs found ({found['same']:,} "
        f"of the same name) in {found['s']:.2f} s, {merged:,} merges; "
        f"{dedup_s:.2f} s in all; peak device memory above the tables "
        f"{peak:.2f} GiB; entity rows live {stats['entity']:,} -> "
        f"{after['entity']:,}")
    if not merged or after["entity"] != stats["entity"] - merged \
            or found["same"] != found["pairs"]:
        raise AssertionError(f"[kg] dedup: {found}, merged {merged}, stats "
                             f"{after}")
    return kg, names, page_names, prep_err


def orch_queries(tokens, page_names):
    """ORCH_QUERIES queries: a stored chunk with TOK_FLIP of its words
    resampled, plus 1-3 entity names of its document's page."""
    rng = np.random.default_rng(51)
    docs = rng.choice(INGEST_DOCS, ORCH_QUERIES, replace=False)
    out = []
    for i, d in enumerate(docs):
        row = int(d) * INGEST_CHUNKS + int(rng.integers(INGEST_CHUNKS))
        names = rng.choice(page_names[d], int(rng.integers(1, 4)),
                           replace=False)
        out.append(noisy_texts(tokens, [row], 900 + i)[0] + " "
                   + " ".join(names))
    return out


def stub_router(names):
    """A STUB router whose "Extract the entities" answer is the
    vocabulary names found in the prompt."""
    import re

    from rag_application_tpu_torch.llm.router import LLMRouter, Provider

    known = set(names)

    def entities(prompt):
        words = re.findall(r"[a-z]+", prompt.split("mentioned in:", 1)[-1])
        found = []
        for a, b in zip(words, words[1:]):
            if f"{a} {b}" in known and f"{a} {b}" not in found:
                found.append(f"{a} {b}")
        return json.dumps({"entities": found, "relations": []})

    llm = LLMRouter(Provider.STUB)
    llm.stub.on(r"Extract the entities", entities)
    return llm


def hit_rows(hits):
    return [(h.row, h.score) for h in hits]


def run_orch(col, emb, kg, names, queries):
    """[orch]: `SearchOrchestrator.execute` on each query, one at a time
    and all at once, then one at a time again with every scan and match
    launch recorded and held against plain. Returns (the results of the
    queries one at a time, the recorded launches' max abs errors as
    `check_recorded` gives them)."""
    import asyncio

    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops.graph_hop import k_hop_expand
    from rag_application_tpu_torch.search.orchestration import \
        SearchOrchestrator

    orch = SearchOrchestrator(col, kg, emb, stub_router(names))
    t0 = time.perf_counter()
    asyncio.run(orch.execute(queries[0], limit=K))  # builds the adjacency
    log(f"  warm-up execute (the adjacency built) {time.perf_counter() - t0:.2f}"
        f" s")

    async def one_at_a_time():
        out = []
        for q in queries:
            t0 = time.perf_counter()
            res = await orch.execute(q, limit=K)
            out.append((res, (time.perf_counter() - t0) * 1e3))
        return out

    async def all_at_once():
        return await asyncio.gather(*(orch.execute(q, limit=K)
                                      for q in queries))

    reset_scan_counts(ft)
    ob.bm25_match_rows.launches = 0
    seq = asyncio.run(one_at_a_time())
    launches = {**scan_counts(ft), "bm25_match": ob.bm25_match_rows.launches}
    t0 = time.perf_counter()
    together = asyncio.run(all_at_once())
    wall = time.perf_counter() - t0
    ms = np.array([m for _, m in seq])
    log(f"  {len(queries)} queries one at a time: p50 {np.percentile(ms, 50):.1f}"
        f" ms, p90 {np.percentile(ms, 90):.1f} ms (host clock, each ending "
        f"in its results on the host); all at once (asyncio.gather) "
        f"{wall * 1e3:.1f} ms -> {len(queries) / wall:.1f} queries/s; "
        f"launches one at a time {launches} "
        f"({sum(launches.values()) / len(queries):.2f} a query)")
    if ft.route_launches["fused_scan"] or not all(launches.values()):
        raise AssertionError(f"[orch] launches {launches}, by kernel "
                             f"{ft.route_launches}")

    # every scan and match launch of one more pass one at a time, against
    # plain at the orchestrator's shapes (Q 1); a query's two branches run
    # in two threads, so each scan's kernel is asked of scan_route
    with recording(ft, "scan_sheet") as scans, \
            recording(ob, "bm25_match_rows") as matches:
        again = asyncio.run(one_at_a_time())
    errs = check_recorded("orch", routed(scans), matches, each=False)

    results = [r for r, _ in seq]
    with_graph = 0
    for i, (q, res) in enumerate(zip(queries, results)):
        g = res["graph"]
        with_graph += bool(g["entities"]) and any(g["paths"])
        q_vec = emb.encode([q])[0]
        direct = col.hybrid_search(q_vec, q, limit=K)
        if hit_rows(res["hits"]) != hit_rows(direct) or not direct:
            raise AssertionError(f"[orch] query {i}: hybrid hits differ from "
                                 f"Collection.hybrid_search")
        if any(hit_rows(r[i]["hits"]) != hit_rows(res["hits"])
               or r[i]["context"] != res["context"]
               for r in (together, [a for a, _ in again])):
            raise AssertionError(f"[orch] query {i}: run concurrently or "
                                 f"again, the result differs")
    share = with_graph / len(queries)
    # the traversal on the card against the port's own k_hop_expand on
    # CPU tensors, for the same adjacency, seeds and beam scores
    traversed = 0
    adj, n = kg.entity_adjacency()
    for q, res in zip(queries[:16], results):
        g = res["graph"]
        p = g["params"]
        seeds = [h["row"] for h in g["entities"][:p.max_paths]]
        if not seeds:
            continue
        kgq = emb.encode([q])[0][:kg.dim]
        sc = kg._beam_scores(kgq, n)
        s = torch.tensor([[r] for r in seeds], dtype=torch.int32,
                         device=adj.device)
        hops = min(p.search_depth, kg.cfg.max_hops)
        vd, hd = k_hop_expand(adj, s, hops, frontier_cap=p.expansion_factor,
                              scores=sc)
        vc, hc = k_hop_expand(adj.cpu(), s.cpu(), hops,
                              frontier_cap=p.expansion_factor,
                              scores=sc.cpu())
        if not (torch.equal(vd.cpu(), vc) and torch.equal(hd.cpu(), hc)):
            raise AssertionError("[orch] k_hop_expand on the card != on the "
                                 "CPU")
        if kg.traverse(seeds, p.search_depth, query_embedding=kgq,
                       frontier_cap=p.expansion_factor) != g["paths"]:
            raise AssertionError("[orch] traverse != the orchestrator's paths")
        traversed += 1
    log(f"  hybrid hits == Collection.hybrid_search on all {len(queries)}; "
        f"concurrent and repeated results == sequential; {with_graph} of {len(queries)} "
        f"({share:.0%}) with entities and a path; traverse on the card == "
        f"k_hop_expand on the CPU for {traversed} queries (ids and hops "
        f"exact)")
    if share < 0.9 or not traversed:
        raise AssertionError(f"[orch] {share:.0%} of queries with a graph")
    return results, errs


def run_batcher(col, emb, tokens):
    """[batcher]: BATCHER_REQS concurrent `search(None, text, K)` calls
    through a `MicroBatcher` built as api/app.py builds it (the tokens
    wire, max_batch 256, 2 ms, two groups in flight). Returns the max
    abs errors of the recorded scans and matches against plain."""
    import asyncio

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.search.batcher import MicroBatcher

    rng = np.random.default_rng(61)
    texts = noisy_texts(tokens, rng.integers(0, col.dense.size, BATCHER_REQS),
                        700)
    groups = []

    def run(embs, batch, limit):
        if embs is not None:
            raise AssertionError("the tokens wire takes texts only")
        groups.append(list(batch))
        return col.hybrid_search_text_batch(batch, limit)

    def drive(inflight=2):
        b = MicroBatcher(run, max_batch=BATCHER_MAX, max_wait_ms=2.0,
                         max_inflight=inflight)

        async def go():
            return await asyncio.gather(*(b.search(None, t, K)
                                          for t in texts))
        t0 = time.perf_counter()
        out = asyncio.run(go())
        return b, out, time.perf_counter() - t0

    drive()  # warm-up
    groups.clear()
    reset_scan_counts(ft)
    ob.bm25_match_rows.launches = 0
    b, out, wall = drive()
    launches = {**scan_counts(ft), "bm25_match": ob.bm25_match_rows.launches}
    sizes = [len(g) for g in groups]
    t0 = time.perf_counter()
    seq = []
    for s in range(0, BATCHER_REQS, BATCHER_MAX):
        seq += col.hybrid_search_text_batch(texts[s:s + BATCHER_MAX], K)
    seq_wall = time.perf_counter() - t0
    log(f"  MicroBatcher: {BATCHER_REQS} requests in {wall * 1e3:.1f} ms -> "
        f"{BATCHER_REQS / wall:,.0f} requests/s; {b.batches_run} batches "
        f"formed (sizes after padding {sizes}); the same requests as "
        f"{BATCHER_REQS // BATCHER_MAX} sequential batches of {BATCHER_MAX}: "
        f"{seq_wall * 1e3:.1f} ms -> {BATCHER_REQS / seq_wall:,.0f} "
        f"requests/s (host clock); launches {launches}")
    if b.requests_served != BATCHER_REQS or ft.route_launches["fused_scan"] \
            or not all(launches.values()):
        raise AssertionError(f"[batcher] served {b.requests_served}, "
                             f"launches {ft.route_launches}")

    # each request's rows and scores == its group run directly
    want = {}
    for g in groups:
        for t, hits in zip(g, col.hybrid_search_text_batch(g, K)):
            want.setdefault(t, []).append(hit_rows(hits))
    bad = sum(hit_rows(h) not in want[t] for t, h in zip(texts, out))
    # against the 8 sequential batches: other rows only at near-ties
    # (a group encodes its texts at another batch shape)
    q_of = {}
    for g in groups + [texts[s:s + BATCHER_MAX]
                       for s in range(0, BATCHER_REQS, BATCHER_MAX)]:
        ids, am = emb.tokenizer.encode_batch(g, emb.max_len)
        q = emb.state.model.apply(emb.state.params,
                                  torch.from_numpy(ids).to(col.device),
                                  torch.from_numpy(am).to(col.device))
        for t, row in zip(g, q):
            q_of.setdefault(t, []).append(row)
    ties, worst = 0, 0.0
    for t, a, c in zip(texts, out, seq):
        ra, rc = [h.row for h in a], [h.row for h in c]
        if ra == rc:
            continue
        qs = q_of[t]
        dq = max(torch.linalg.vector_norm(x - qs[-1]).item() for x in qs)
        sa = exact_scores(col.dense, qs[-1][None], [ra])[0]
        sc = exact_scores(col.dense, qs[-1][None], [rc])[0]
        gap = (sa - sc).abs().max().item()
        if len(ra) != len(rc) or gap > 2.01 * dq + 1e-5:
            raise AssertionError(f"[batcher] rows differ beyond a near-tie: "
                                 f"gap {gap:.3g}, |dq| {dq:.3g}")
        ties += 1
        worst = max(worst, gap)
    log(f"  results == hybrid_search_text_batch of the same groups for "
        f"{BATCHER_REQS - bad} of {BATCHER_REQS}; against the sequential "
        f"batches {ties} near-ties (worst positional score gap {worst:.3g})")
    if bad:
        raise AssertionError(f"[batcher] {bad} requests differ from their "
                             f"group run directly")

    # every scan and match launch of one more run, against plain (two
    # groups in flight: each scan's kernel is asked of scan_route)
    with recording(ft, "scan_sheet") as scans, \
            recording(ob, "bm25_match_rows") as matches:
        drive()
    errs = check_recorded("batcher", routed(scans), matches)
    log(f"  batcher: {len(scans)} scan and {len(matches)} match launches "
        f"held against plain")

    # the device's idle share over one profiled run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, pwall = drive()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    log(f"[profile] one MicroBatcher run of {BATCHER_REQS} requests: "
        f"{pwall * 1e3:.1f} ms wall (host clock, profiled); device busy "
        f"{busy:.1f} ms ({busy / (pwall * 1e3):.1%}), idle "
        f"{1 - busy / (pwall * 1e3):.1%}")

    # one group in flight against two (api/app.py's), one run each
    one = drive(1)[2]
    two = drive(2)[2]
    log(f"  max_inflight 1: {one * 1e3:.1f} ms ({BATCHER_REQS / one:,.0f} "
        f"requests/s); max_inflight 2: {two * 1e3:.1f} ms "
        f"({BATCHER_REQS / two:,.0f} requests/s) (host clock)")
    return errs


def run_hybrid(col, emb, tokens):
    """[hybrid]: `HybridSearcher.search` (the staged funnel) on
    HYB_QUERIES queries over the collection's dense and sparse tables.
    Returns the max abs error of its matches against plain."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.search.hybrid import HybridSearcher

    rng = np.random.default_rng(71)
    texts = noisy_texts(tokens, rng.integers(0, col.dense.size, HYB_QUERIES),
                        800)
    q = emb.encode(texts)
    hs = HybridSearcher(col.dense, col.sparse, col._funnel(None, True))
    hs.search(q[:8], texts[:8], K)
    ob.bm25_match_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hs.search(q, texts, K)
    ms = (time.perf_counter() - t0) * 1e3
    launches = ob.bm25_match_rows.launches
    exact = exact_top_ids(col.dense, torch.from_numpy(q).to(col.device), K,
                          live_only=True)
    recall = float(np.mean([np.isin(exact[r], res.rows[r]).mean()
                            for r in range(HYB_QUERIES)]))
    log(f"  HybridSearcher.search, {HYB_QUERIES} queries: {ms:.1f} ms (host "
        f"clock, results on the host); recall@10 vs exact over the live "
        f"rows {recall:.4f}; bm25_match_rows launches {launches}")
    with recording(ob, "bm25_match_rows") as matches:
        again = hs.search(q, texts, K)
    if not np.array_equal(again.rows, res.rows):
        raise AssertionError("[hybrid] a second search differs")
    err = check_matches("hybrid", matches)
    if launches != 1 or recall < 0.95:
        raise AssertionError(f"[hybrid] launches {launches}, recall "
                             f"{recall:.4f}")
    return err


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


class CaptureHook:
    """Stands in for a store's lock: runs ``after`` once, right after the
    first release that follows its setting (the moment a save has
    captured its references and has not copied them yet)."""

    def __init__(self, lock):
        self.lock = lock
        self.after = None

    def __enter__(self):
        return self.lock.__enter__()

    def __exit__(self, *exc):
        out = self.lock.__exit__(*exc)
        fn, self.after = self.after, None
        if fn is not None:
            fn()
        return out


def same_dense(a, b):
    """Two dense indexes hold the same size and planes, bit for bit."""
    import torch

    def eq(x, y):
        if x is None or y is None:
            return x is y
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        return torch.equal(x, y)

    return a.size == b.size and all(
        eq(getattr(a, n), getattr(b, n))
        for n in ("vecs", "int8", "inv_norms", "live"))


def run_checkpoint(col, kg, emb, names, queries, results, tok_texts, dev):
    """[checkpoint]: `save_collection` and `save_kg`, then both loaded on
    the card: the tables equal, one tokens-wire batch and the orchestrator
    queries answered the same, their scan and match launches held against
    plain; then a save during which another thread deletes a document and
    inserts one, whose snapshot must be the state at capture. Returns the
    recorded launches' max abs errors as `check_recorded` gives them."""
    import asyncio
    import os
    import shutil
    import threading

    import torch

    from rag_application_tpu_torch.config import Config, KGConfig
    from rag_application_tpu_torch.index.checkpoint import (load_collection,
                                                            save_collection)
    from rag_application_tpu_torch.kg.checkpoint import load_kg, save_kg
    from rag_application_tpu_torch.kg.store import Space
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.search.orchestration import \
        SearchOrchestrator

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), CKPT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cpath, kpath = os.path.join(root, "collection"), os.path.join(root, "kg")
    t0 = time.perf_counter()
    save_collection(col, cpath)
    t1 = time.perf_counter()
    save_kg(kg, kpath)
    t2 = time.perf_counter()
    col2 = load_collection(cpath, Config(), device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    kg2 = load_kg(kpath, KGConfig(), device=dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    log(f"  save_collection {t1 - t0:.2f} s, {dir_bytes(cpath) / 1e6:,.1f} MB"
        f" on disk; save_kg {t2 - t1:.2f} s, {dir_bytes(kpath) / 1e6:,.1f} "
        f"MB; load_collection {t3 - t2:.2f} s, load_kg {t4 - t3:.2f} s (on "
        f"the card)")
    sp, sp2 = col.sparse, col2.sparse
    if not (same_dense(col.dense, col2.dense)
            and all(np.array_equal(x, y) for x, y in zip(sp._flat(),
                                                         sp2._flat()))
            and sp._deleted == sp2._deleted
            and col.payloads._payloads == col2.payloads._payloads
            and all(same_dense(kg.spaces[s].index, kg2.spaces[s].index)
                    and kg.spaces[s].by_key == kg2.spaces[s].by_key
                    for s in Space)
            and kg.entity_edges == kg2.entity_edges
            and kg.stats() == kg2.stats()):
        raise AssertionError("[checkpoint] restored tables differ")

    col2.bind_query_encoder(emb)
    orch = SearchOrchestrator(col2, kg2, emb, stub_router(names))

    async def answer():
        return [await orch.execute(q, limit=K) for q in queries]

    # the restored stores' scan and match launches, held against plain
    with recording(ft, "scan_sheet") as scans, \
            recording(ob, "bm25_match_rows") as matches:
        t0 = time.perf_counter()
        b = col2.hybrid_search_text_batch(tok_texts, K)
        first = time.perf_counter() - t0
        answers = asyncio.run(answer())
    errs = check_recorded("restored", routed(scans), matches, each=False)
    a = col.hybrid_search_text_batch(tok_texts, K)
    if [hit_rows(h) for h in a] != [hit_rows(h) for h in b]:
        raise AssertionError("[checkpoint] a tokens batch differs after the "
                             "restore")
    for i, (x, y) in enumerate(zip(results, answers)):
        if hit_rows(x["hits"]) != hit_rows(y["hits"]) \
                or x["context"] != y["context"]:
            raise AssertionError(f"[checkpoint] orchestrator query {i} "
                                 f"differs after the restore")
    log(f"  restored: tables bit-equal; a tokens batch of {len(tok_texts)} "
        f"(the first search rebuilding BM25's device tables: "
        f"{first * 1e3:.0f} ms) and the {len(queries)} orchestrator queries "
        f"give the same rows, bit-equal scores and the same contexts")
    del col2, kg2, orch, scans, matches

    # a save while another thread deletes a document and inserts one
    chunks = [{"text": tok_texts[i % len(tok_texts)], "page": -1}
              for i in range(INGEST_CHUNKS)]
    vecs = emb.encode([c["text"] for c in chunks])
    victim = "doc-7"
    at = {}

    def write():
        col.delete_document(victim)
        col.store_document_vectors("doc-extra", chunks, vecs)

    def during():  # the save has captured; copy nothing yet
        d = col.dense
        at.update(size=d.size, vecs=d.vecs, int8=d.int8, live=d.live,
                  live_copy=d.live.clone(), n_payloads=len(col.payloads))
        w = threading.Thread(target=write)
        w.start()
        w.join(timeout=120)
        at["writer_done"] = not w.is_alive()

    lock = col.lock
    col.lock = CaptureHook(lock)
    col.lock.after = during
    spath = os.path.join(root, "during")
    try:
        save_collection(col, spath)
    finally:
        col.lock = lock
    snap = load_collection(spath, Config(), device=dev)
    d = col.dense
    ok = (at["writer_done"] and snap.dense.size == at["size"]
          and torch.equal(snap.dense.live, at["live_copy"])
          and torch.equal(at["live"], at["live_copy"])
          and torch.equal(snap.dense.vecs.view(torch.int16),
                          at["vecs"].view(torch.int16))
          and torch.equal(snap.dense.int8, at["int8"])
          and len(snap.payloads) == at["n_payloads"]
          and len(snap.payloads.rows_where(document_id=victim)) == INGEST_CHUNKS
          and not snap.payloads.rows_where(document_id="doc-extra")
          and not col.payloads.rows_where(document_id=victim)
          and len(col.payloads.rows_where(document_id="doc-extra"))
          == INGEST_CHUNKS and d.size == at["size"] + INGEST_CHUNKS
          and d.live.data_ptr() != at["live"].data_ptr())
    log(f"  a save with a delete and an insert in another thread between "
        f"its capture and its copies: snapshot size {snap.dense.size:,}, "
        f"live flags, rows and payloads == the state at capture {ok}; the "
        f"collection after: size {d.size:,}, {victim!r} deleted, "
        f"'doc-extra' stored")
    del snap
    shutil.rmtree(root)
    if not ok:
        raise AssertionError("[checkpoint] the snapshot taken during writes "
                             "is not the state at capture")
    return errs


def pipeline_docs(names):
    """[pipeline]'s traffic: (kind, document id, bytes) of the real
    fixtures, the generated text documents, a built PDF and docx, and the
    HTML page the stub fetcher serves for PIPE_URL."""
    import importlib.util
    import os

    from rag_application_tpu_torch.ingest.chunker import chunk_words

    # the repo's fixture makers, loaded by path: a `tests` package
    # installed in site-packages can shadow the checkout's directory
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "fixtures", "make_fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    docs = []
    for name in PIPE_REAL:
        with open(f"tests/fixtures/real/{name}", "rb") as f:
            docs.append((name.rsplit(".", 1)[1].lower(), name, f.read()))
    rng = np.random.default_rng(23)
    words = rng.choice(VOCAB, size=(PIPE_DOCS, PIPE_CHUNKS * 1800),
                       p=zipf_probs(VOCAB))
    for d in range(PIPE_DOCS):
        text = " ".join(f"w{t}" for t in words[d])
        text = " ".join(chunk_words(text, 8000)[:PIPE_CHUNKS])
        docs.append(("text", f"gen-{d:03d}.txt", text.encode()))
    lines = [" ".join(names[7 * i:7 * i + 7]) for i in range(24)]
    docs.append(("pdf", "built.pdf", fixtures.build_pdf(
        [fixtures.text_page(lines[i:i + 8]) for i in (0, 8, 16)])))
    docs.append(("docx", "built.docx", fixtures.build_docx(
        [lines[:12], lines[12:]])))
    html = ("<html><head><title>Retrieval guide</title><script>track()"
            "</script></head><body><h1>Retrieval</h1>" + "".join(
                f"<p>{ln}.</p>" for ln in lines * 20) + "</body></html>")
    docs.append(("url", PIPE_URL, html.encode()))
    return docs


def pipeline_extractor(vocab, calls):
    """The KG extractor stub: a page of [kg]'s shape drawn from [kg]'s
    vocabulary, seeded by the text (the same text, the same page).
    Appends (entities, relationships) per call to ``calls``."""
    import zlib

    names, types, phrases = vocab
    zipf = zipf_probs(KG_NAMES)

    def extract(text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        found = kg_page(rng, names, types, phrases, zipf)[2]
        calls.append((len(found["entities"]), len(found["relationships"])))
        return found

    return extract


def expected_chunks(kind, data):
    """Chunk tasks a document fans out to, by the ported parsers."""
    from rag_application_tpu_torch.ingest import office, pdf
    from rag_application_tpu_torch.ingest.chunker import chunk_words
    from rag_application_tpu_torch.tools.web import html_to_text

    if kind == "pdf":
        return len(pdf.extract_pages(data))
    if kind in ("docx", "pptx"):
        return len(office.extract_pages(data))
    text = data.decode()
    return len(chunk_words(html_to_text(text) if kind == "url" else text,
                           8000))


def timed(obj, name, log):
    """Wrap ``obj.name`` to append (len(first argument) or None, host
    seconds) per call to ``log`` (the calls may come from threads)."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log.append((len(args[0]) if isinstance(args[0], list) else None,
                    time.perf_counter() - t0))
        return out

    setattr(obj, name, wrapper)


def check_preps(label, preps):
    """Each recorded `prepare_vectors_into` launch against the plain
    version on the same rows, bit for bit, in the index's planes. Returns
    the launches by (rows, dims)."""
    import torch

    from rag_application_tpu_torch.ops import quant as oq

    shapes = {}
    for args, _, _, _ in preps:
        x, dims, pv, pi, inv, live, start = args
        end = start + x.shape[0]
        want = oq.prepare_vectors_plain(x, dims)
        ok = (torch.equal(pv[start:end].view(torch.int16),
                          want[0].view(torch.int16))
              and torch.equal(pi[start:end], want[1])
              and torch.equal(inv[start:end], want[2])
              and bool(live[start:end].all().item()))
        if not ok:
            raise AssertionError(f"{label}: a prep launch at row {start}, "
                                 f"dims {dims}, != plain")
        key = (x.shape[0], tuple(dims))
        shapes[key] = shapes.get(key, 0) + 1
    log(f"  {label}: {len(preps)} prep launches bit-equal to plain in the "
        f"index's planes, by (rows, dims): {shapes}")
    return shapes


def keyed_rows(col, docs):
    """{(document id, page_number or chunk_index): row} of the live
    chunks of ``docs`` (a page's chunk also carries chunk_index 0)."""
    out = {}
    for doc in docs:
        for r in col.payloads.rows_where(document_id=doc):
            p = col.payloads.get(r)
            out[(doc, p.get("page_number", p.get("chunk_index")))] = r
    return out


def same_rows(a, ra, b, rb):
    """Rows ``ra`` of dense index ``a`` and ``rb`` of ``b``, bit for bit."""
    import torch

    ra, rb = (torch.as_tensor(r, device=a.vecs.device) for r in (ra, rb))
    return all(torch.equal(x[ra].view(torch.uint8), y[rb].view(torch.uint8))
               for x, y in ((a.vecs, b.vecs), (a.int8, b.int8),
                            (a.inv_norms, b.inv_norms), (a.live, b.live)))


def run_pipeline(col, emb, kg, ing_rate, dev):
    """[pipeline]: the documents of `pipeline_docs` through
    `IngestPipeline` (the API's wiring: `IngestConfig()`, an ObjectStore,
    the KG hook), one `ingest_file` / `ingest_url` call each, into ``col``
    and ``kg``, then one document again. Checks the ledgers and counts,
    the prep launches (equal to the inserts; the first document's held
    to plain), the same documents at `max_concurrency=1` into fresh
    stores (same payloads, bit-equal vectors by key) and a tokens-wire
    batch over the new chunks. Returns (prep launches, (int8 scan, bf16
    scan, bm25) max abs errs); the prep launches held are bit-equal."""
    import asyncio
    import shutil

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rag_application_tpu_torch.config import Config, IngestConfig
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.ingest.pipeline import IngestPipeline
    from rag_application_tpu_torch.kg.store import KGStore, Space
    from rag_application_tpu_torch.models.embedder import Embedder
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops import quant as oq
    from rag_application_tpu_torch.store.collection import Collection
    from rag_application_tpu_torch.store.objects import ObjectStore

    t0 = time.perf_counter()
    vocab = kg_vocab(np.random.default_rng(17))  # [kg]'s vocabulary
    docs = pipeline_docs(vocab[0])
    want = {doc: expected_chunks(kind, data) for kind, doc, data in docs}
    pages = {doc: (1 if kind in ("text", "url") else want[doc])
             for kind, doc, _ in docs}
    html = {doc: data.decode() for kind, doc, data in docs if kind == "url"}

    async def fetch(url):  # the stub fetcher: no network
        return html[url]

    def pipeline(col, emb, kg, root, calls, concurrency):
        shutil.rmtree(root, ignore_errors=True)
        return IngestPipeline(
            col, emb, kg=kg, kg_extractor=pipeline_extractor(vocab, calls),
            object_store=ObjectStore(root), url_fetcher=fetch,
            config=IngestConfig(max_concurrency=concurrency))

    def ingest(pipe, kind, doc, data):
        if kind == "url":
            return asyncio.run(pipe.ingest_url(doc, document_id=doc))
        return asyncio.run(pipe.ingest_file(doc, data, document_id=doc))

    calls = []
    cfg = IngestConfig()
    pipe = pipeline(col, emb, kg, PIPE_OBJECTS, calls, cfg.max_concurrency)
    enc, store, upsert = [], [], []
    timed(emb, "encode", enc)  # undone at the end
    timed(col, "store_document_vectors", store)
    timed(kg, "upsert_unstructured_page", upsert)
    col.bind_query_encoder(emb)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: {len(docs)} documents "
        f"({sum(want.values()):,} chunk tasks), IngestConfig(): chunk_chars "
        f"{cfg.chunk_chars}, max_concurrency {cfg.max_concurrency}, "
        f"max_retries {cfg.max_retries}; into {col.chunk_count():,} chunks "
        f"and a KG of {kg.stats()}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oq.prepare_vectors_into.launches = 0
    oq.prepare_vectors.launches = 0
    results, by_kind, busy = {}, {}, None
    profiled = next(doc for kind, doc, _ in docs if kind == "text")
    for i, (kind, doc, data) in enumerate(docs):
        prof = None
        if doc == profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t1 = time.perf_counter()
        if i == 0:  # the first document's launches, held against plain
            with recording(idense, "prepare_vectors_into") as preps:
                res = ingest(pipe, kind, doc, data)
        else:
            res = ingest(pipe, kind, doc, data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        if prof is not None:
            prof.__exit__(None, None, None)
            busy = (sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e3, dt * 1e3)
        results[doc] = res
        n_docs, n_chunks, secs = by_kind.get(kind, (0, 0, 0.0))
        by_kind[kind] = (n_docs + 1, n_chunks + res.chunks, secs + dt)
    launches = oq.prepare_vectors_into.launches
    total_s = sum(v[2] for v in by_kind.values())
    n_tasks = sum(r.chunks for r in results.values())
    shapes = check_preps(f"the first document ({docs[0][1]})", preps)
    if set(shapes) != {(1, PREP_DIMS), (1, ())}:
        raise AssertionError(f"[pipeline] prep shapes {shapes}")

    for kind, (n_docs, n_chunks, secs) in by_kind.items():
        log(f"  {kind}: {n_docs} documents, {n_chunks:,} chunks in "
            f"{secs:.2f} s -> {n_docs / secs:,.2f} documents/s, "
            f"{n_chunks / secs:,.1f} chunks/s")
    log(f"  all: {len(docs)} documents, {n_tasks:,} chunk tasks in "
        f"{total_s:.2f} s -> {len(docs) / total_s:.2f} documents/s, "
        f"{n_tasks / total_s:,.1f} chunks/s; [ingest] {ing_rate:,.0f} "
        f"chunks/s (64-chunk documents, one encode and one store call "
        f"each, no KG)")
    one = [t for n, t in enc if n == 1]
    many = [t for n, t in enc if n != 1]
    log(f"  per chunk task (host clocks, ms, mean / median): encode of the "
        f"chunk {np.mean(one) * 1e3:.2f} / {np.median(one) * 1e3:.2f} "
        f"({len(one):,} calls), encode of its KG rows "
        f"{np.mean(many) * 1e3:.2f} / {np.median(many) * 1e3:.2f} "
        f"({len(many):,} calls; texts ~{KG_ENTS} and {KG_RELS}), store "
        f"{np.mean([t for _, t in store]) * 1e3:.2f} / "
        f"{np.median([t for _, t in store]) * 1e3:.2f}, KG upsert "
        f"{np.mean([t for _, t in upsert]) * 1e3:.2f} / "
        f"{np.median([t for _, t in upsert]) * 1e3:.2f}; encoder cache "
        f"{len(emb.cache):,} entries")
    log(f"[profile] one generated document ({profiled}, {PIPE_CHUNKS} chunk "
        f"tasks): {busy[1]:.1f} ms wall (host clock); device busy "
        f"{busy[0]:.2f} ms ({busy[0] / busy[1]:.1%}), idle "
        f"{1 - busy[0] / busy[1]:.1%}")

    # the ledgers, the counts and the launches
    failed = [(t.task_type.value, t.error) for t in pipe.queue.failed]
    wrong = {d: (r.chunks, r.pages, r.failed_tasks)
             for d, r in results.items()
             if (r.chunks, r.pages, r.failed_tasks) != (want[d], pages[d], 0)
             or r.chunks != col.chunk_count(document_id=d)}
    kg_rows = sum(1 + e + r for e, r in calls)
    log(f"  failed ledger {failed}; results against the parsers' counts and "
        f"the payload table: {len(results) - len(wrong)} of {len(results)} "
        f"agree; prepare_vectors_into launches {launches:,} = Collection "
        f"inserts {n_tasks:,} + KG rows {kg_rows:,} "
        f"({len(calls):,} pages): {launches == n_tasks + kg_rows}; "
        f"prepare_vectors {oq.prepare_vectors.launches}")
    if failed or wrong or launches != n_tasks + kg_rows \
            or oq.prepare_vectors.launches or len(calls) != n_tasks:
        raise AssertionError(f"[pipeline] failed {failed}, wrong {wrong}, "
                             f"launches {launches}, calls {len(calls)}")

    # one document again: the same chunks and KG
    kind, doc, data = docs[len(PIPE_REAL)]
    before = (col.chunk_count(), kg.stats())
    res = ingest(pipe, kind, doc, data)
    after = (col.chunk_count(), kg.stats())
    log(f"  re-ingest of {doc}: {res}; chunk_count and KG stats unchanged: "
        f"{after == before}")
    if after != before or res.chunks != want[doc] or pipe.queue.failed:
        raise AssertionError(f"[pipeline] re-ingest: {before} -> {after}")
    pipe_launches = oq.prepare_vectors_into.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    del emb.encode, col.store_document_vectors, kg.upsert_unstructured_page

    # the documents again at max_concurrency=1 into fresh stores, with a
    # fresh embedding cache: the same payloads and vectors, by key (all
    # but the generated ones past the first PIPE_SERIAL_DOCS, a depth cut
    # that keeps the whole run inside half its time limit)
    again = docs[:len(PIPE_REAL) + PIPE_SERIAL_DOCS] \
        + docs[len(PIPE_REAL) + PIPE_DOCS:]
    col1 = Collection("user_pipeline_serial", Config(), device=dev)
    kg1 = KGStore(kg.cfg, dim=kg.dim, device=dev)
    emb1 = Embedder(emb.state, tokenizer=emb.tokenizer, max_len=emb.max_len,
                    batch_size=emb.batch_size)
    pipe1 = pipeline(col1, emb1, kg1, PIPE_OBJECTS + "_serial", [], 1)
    t1 = time.perf_counter()
    for kind, doc, data in again:
        ingest(pipe1, kind, doc, data)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t1
    ka, kb = keyed_rows(col, want), keyed_rows(col1, want)
    keys = sorted(kb)
    same_payloads = set(keys) <= set(ka) and len(keys) == sum(
        want[d] for _, d, _ in again) and all(
        col.payloads.get(ka[k]) == col1.payloads.get(kb[k]) for k in keys)
    same_vecs = same_rows(col.dense, [ka[k] for k in keys],
                          col1.dense, [kb[k] for k in keys])
    # KG rows by key, bit for bit; a relationship key met on several pages
    # of a document keeps the last upsert's profile (MERGE), and which
    # page is last depends on the workers' order: such rows may differ,
    # at most one a re-upsert of the serial pass
    kg_same, moved = True, 0
    for space, table in kg1.spaces.items():
        big = kg.spaces[space]
        kk = sorted(table.by_key, key=repr)
        if not all(k in big.by_key for k in kk):
            kg_same = False
            continue
        ra = [big.by_key[k] for k in kk]
        rb = [table.by_key[k] for k in kk]
        eq = [big.payloads[a] == table.payloads[b] for a, b in zip(ra, rb)]
        ok = [i for i, e in enumerate(eq) if e]
        kg_same &= not ok or same_rows(big.index, [ra[i] for i in ok],
                                       table.index, [rb[i] for i in ok])
        if space is Space.RELATIONSHIP:
            moved = len(eq) - len(ok)
            kg_same &= moved <= table.tombstones
        else:
            kg_same &= len(ok) == len(eq)
    log(f"  max_concurrency=1 into fresh stores, {len(again)} of the "
        f"documents: {len(keys):,} chunks in {serial_s:.2f} s "
        f"({len(keys) / serial_s:,.1f} chunks/s); by (document, page or "
        f"chunk): payloads equal {same_payloads}, stored vectors "
        f"bit-equal {same_vecs}; KG rows by key: payloads and vectors "
        f"equal {kg_same} ({kg1.stats()}; {moved} relationship rows hold "
        f"another page's profile, of {kg1.spaces[Space.RELATIONSHIP].tombstones}"
        f" merged re-upserts)")
    if not (same_payloads and same_vecs and kg_same) or pipe1.queue.failed:
        raise AssertionError("[pipeline] max_concurrency=1 differs")
    del col1, kg1, emb1, pipe1
    for root in (PIPE_OBJECTS, PIPE_OBJECTS + "_serial"):
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # a tokens-wire batch of noisy chunk texts from the new documents
    rng = np.random.default_rng(29)
    gen = [r for (d, _), r in sorted(ka.items()) if d.startswith("gen-")]
    rows = rng.choice(gen, TOK_BATCH, replace=False)
    texts = []
    for r in rows:
        w = col.payloads.get(int(r))["text"].split()[:emb.max_len - 2]
        flip = rng.random(len(w)) < TOK_FLIP
        texts.append(" ".join(f"w{rng.integers(VOCAB)}" if f else x
                              for x, f in zip(w, flip)))
    col.hybrid_search_text_batch(texts, K)  # warm-up (the sparse rebuild)
    with recording(ft, "scan_sheet", ft.route_launches) as scans, \
            recording(ob, "bm25_match_rows") as matches:
        hits = col.hybrid_search_text_batch(texts, K)
    errs = check_recorded("[pipeline] tokens wire", scans, matches,
                          each=False)
    ids, am = emb.tokenizer.encode_batch(texts[:N_EVAL], emb.max_len)
    q = emb.state.model.apply(emb.state.params,
                              torch.from_numpy(ids).to(dev),
                              torch.from_numpy(am).to(dev))
    exact = exact_top_ids(col.dense, q, K, live_only=True)
    recall = float(np.mean([np.isin(exact[i], [h.row for h in hits[i]]).mean()
                            for i in range(N_EVAL)]))
    found = np.mean([rows[i] in [h.row for h in hits[i]]
                     for i in range(TOK_BATCH)])
    log(f"  tokens wire over the new chunks, {TOK_BATCH} noisy chunk texts: "
        f"recall@10 vs exact (live rows) on {N_EVAL} queries {recall:.4f}; "
        f"the source chunk among the hits for {found:.1%}")
    if recall < 0.95:
        raise AssertionError(f"[pipeline] recall@10 {recall:.4f} < 0.95")
    log(f"  device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"(peak {peak:.2f} GiB over the default-concurrency pass)")
    return pipe_launches, errs


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


def batch_attn_inputs(dev, B, S, KVH, G, hd, seed, prompt_pad=BATCH_PROMPT):
    """Queries and an int8 cache as `attn_inputs` makes them, and the
    visibility mask of a batcher's decode step: each row's prompt slots
    [0, plen) live and its pad slots DEAD, decode slots from prompt_pad on
    with scattered DEAD gaps (rejected speculative slots, compacted
    rows), the query at the row's next position; the last row free
    (every slot DEAD, masked whole)."""
    import torch

    qg, ck, cv, _ = attn_inputs(dev, B, S, KVH, G, hd, seed)
    rng = np.random.default_rng(seed)
    slot_pos = np.full((B, S), 2 ** 30, np.int64)
    for b in range(B - 1):
        plen = int(rng.integers(prompt_pad // 2, prompt_pad + 1))
        slot_pos[b, :plen] = np.arange(plen)
        n_dec = S - prompt_pad - 64 * (b % 3)
        live = rng.random(n_dec) > 0.35
        slot_pos[b, prompt_pad:prompt_pad + n_dec] = np.where(
            live, plen + np.cumsum(live) - 1, 2 ** 30)
    pos = np.where(slot_pos < 2 ** 30, slot_pos, -1).max(axis=1)
    mask = torch.from_numpy(slot_pos <= pos[:, None]).to(dev)
    return qg, ck, cv, mask


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
    """Kernel vs plain at ten geometries; each case within 2 bf16 ulps of
    max|out| (the kernel rounds p*v_scale against its chunk's max, the
    plain version against the row's), fully masked rows exactly 0. The
    case with one visible slot a row must equal the plain version and
    bf16(bf16(v_scale) * v8) bit for bit: every byte value goes through
    the kernel's conversion once there, and nothing else rounds. Returns
    (worst max abs err, main-shape inputs, [batch]-shape inputs)."""
    import torch

    from rag_application_tpu_torch.ops import decode_attn as da

    worst, main, batch = 0.0, None, None
    cases = [("main decode shape, masked prefix + empty row", ATTN_MAIN,
              "masked"),
             ("[batch]'s shape, a batcher's DEAD gaps + a free row",
              BATCH_ATTN, "batch"),
             ("B 1, S 256", (1, 256, 4, 8, 64), "random"),
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
        elif kind == "batch":
            args = batch_attn_inputs(dev, B, S, KVH, G, hd, 11 + i)
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
        if kind == "batch":
            batch = args
        del args, k_out, p_out
    return worst, main, batch


def time_decode_attn(dev, main, batch):
    """Kernel, plain and library ms at the main decode shape, at [batch]'s
    B 8, S 768 and at the chat's B 1, S 1024, beside the bytes bound. Kernel and library times
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
    for label, args in (("main decode shape", main),
                        ("[batch]'s decode step, B 8", batch),
                        ("chat, B 1", chat)):
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


def batch_header_and_questions(rng, n, vocab):
    """[batch]'s conversations: one system header of BATCH_HEADER tokens
    (``[CLS] [UNK] :`` and whole words of `vocab`, `serve_vocab`'s list)
    shared by every chat, and ``n`` user questions that fill each rendered
    prompt to exactly BATCH_PROMPT tokens."""
    whole = [w for w in vocab if w.startswith("w")]

    def words(k):
        return " ".join(whole[int(i)] for i in rng.integers(0, len(whole), k))

    header = words(BATCH_HEADER - 3)
    # render: [CLS] system : header user : question assistant : ([SEP] cut)
    questions = [words(BATCH_PROMPT - BATCH_HEADER - 4) for _ in range(n)]
    return header, questions


def teacher_forced(params, cfg, prompts, outs, dev):
    """Score each (prompt, output) pair in one solo forward of prompt +
    output (the einsum path at T = its length): at every step, the gap
    between that step's top logit and the logit of the token the output
    chose. Returns (largest gap, share of steps where the token is the
    argmax)."""
    import torch

    from rag_application_tpu_torch.models import decoder as dec

    T = max(len(p) + len(o) for p, o in zip(prompts, outs))
    ids = torch.zeros((len(prompts), T), dtype=torch.int32)
    for b, (p, o) in enumerate(zip(prompts, outs)):
        ids[b, :len(p) + len(o)] = torch.tensor(list(p) + list(o))
    ids = ids.to(dev)
    ck, cv = dec.init_kv_cache(cfg, len(prompts), T, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        len(prompts), T)
    with torch.no_grad():
        x, _, _ = dec.forward(params, cfg, ids, positions, ck, cv)
        worst, hits, steps = 0.0, 0, 0
        for b, (p, o) in enumerate(zip(prompts, outs)):
            if not o:
                continue
            lg = dec._project(params, cfg, x[b, len(p) - 1:len(p) - 1 + len(o)])
            chosen = torch.tensor(o, device=dev).long()
            gap = lg.max(-1).values - lg.gather(1, chosen[:, None])[:, 0]
            worst = max(worst, gap.max().item())
            hits += int((lg.argmax(-1) == chosen).sum())
            steps += len(o)
    del ck, cv, x
    return worst, hits / max(steps, 1)


def record_ids(batcher):
    """Wrap `batcher.submit` (which `LocalLLM.chat` awaits) to keep each
    request's token ids by (prompt, adapter id); returns the dict it
    fills."""
    seen = {}
    real = batcher.submit

    async def submit(prompt_ids, **kw):
        out = await real(prompt_ids, **kw)
        seen[(tuple(prompt_ids), kw.get("adapter_id", 0))] = out
        return out

    batcher.submit = submit
    return seen


def run_batch(params, cfg, dev):
    """[batch]: concurrent chats through `LocalLLM.enable_batching` at the
    repo's documented batcher setting (docs/decoder.md, examples/
    tune_batcher.py): 8 slots, prompt 256 + horizon 512, chunks of 64,
    lookahead 2, on [gen-main]'s weights and flags. Returns (decode_attn
    launches of the main run, max abs err of its checked launches)."""
    import asyncio

    import torch

    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage
    from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer
    from rag_application_tpu_torch.ops import decode_attn as da

    words = serve_vocab(cfg.vocab_size)
    tok = WordPieceTokenizer.from_vocab_list(words, max_len=cfg.max_len)
    # eos ([SEP]) unreachable for greedy decodes: its LM-head column scaled
    # to 0, so its logit is 0 against the ~N(0, 1) others (a grammar's
    # accepting states, where only eos is allowed, still reach it)
    sep = words.index("[SEP]")
    head = {"q": params["lm_head"]["q"], "s": params["lm_head"]["s"].clone()}
    head["s"][sep] = 0.0
    params = {**params, "lm_head": head}
    llm = LocalLLM(params, cfg, tok, model_name="tinyllama-1.1b-random",
                   device=dev)
    rng = np.random.default_rng(7)
    header, questions = batch_header_and_questions(rng, BATCH_REQS + 1,
                                                   words)
    convs = [[ChatMessage("system", header), ChatMessage("user", q)]
             for q in questions]
    prompts = [llm.render(c) for c in convs]
    if {len(p) for p in prompts} != {BATCH_PROMPT}:
        raise AssertionError(f"[batch] prompt lengths {set(map(len, prompts))}")
    warm, main_convs = convs[-1], convs[:BATCH_REQS]
    prompts = prompts[:BATCH_REQS]

    def batcher(**kw):
        b = llm.enable_batching(slots=BATCH_SLOTS, prompt_pad=BATCH_PROMPT,
                                horizon=BATCH_HORIZON, chunk=BATCH_CHUNK,
                                lookahead=BATCH_LOOKAHEAD, **kw)
        n = llm.register_prefix_text(f"system: {header}\n")
        if n != BATCH_HEADER:
            raise AssertionError(f"[batch] prefix of {n} tokens")
        return b, record_ids(b)

    async def timed_chat(c, **kw):
        t0 = time.perf_counter()
        r = await llm.chat(c, **kw)
        return r, time.perf_counter() - t0

    async def many(cs, **kw):
        return await asyncio.gather(*[timed_chat(c, **kw) for c in cs])

    # decode attention: the first BATCH_ATTN_CHECKS launches held to plain
    # as they run (the cache is written in place after each). While it
    # stands in for the wrapper, the wrapper counts its launches on it.
    real_attn = da.decode_attend_int8
    attn_err = [0.0]

    def attn_checked(*args):
        out = real_attn(*args)
        if attn_checked.launches <= BATCH_ATTN_CHECKS:
            plain = da.decode_attend_int8_plain(*args)
            err = (out.float() - plain.float()).abs().max().item()
            if err > 2 * bf16_ulp(plain.float().abs().max().item()):
                raise AssertionError(f"[batch] decode_attn != plain: {err}")
            attn_err[0] = max(attn_err[0], err)
        return out

    attn_checked.launches = 0

    # ---- the main run: BATCH_REQS chats at once, after one warm-up chat
    # (as examples/tune_batcher.py warms its batcher)
    b, seen = batcher()
    asyncio.run(many([warm], max_tokens=BATCH_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0, comp0, hits0 = b.steps, b.compactions, b.prefix_hits
    da.decode_attend_int8 = attn_checked
    try:
        t0 = time.perf_counter()
        res = asyncio.run(many(main_convs, max_tokens=BATCH_NEW))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        da.decode_attend_int8 = real_attn
    launches = attn_checked.launches
    steps = b.steps - steps0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plain_ids = [seen[(tuple(p), 0)] for p in prompts]
    n_tok = sum(r.usage["completion_tokens"] for r, _ in res)
    lat = [s for _, s in res]
    log(f"  batched: {BATCH_REQS} chats x {BATCH_NEW} new at once in "
        f"{wall:.2f} s -> {n_tok / wall:.1f} tokens/s; latency p50 "
        f"{np.percentile(lat, 50):.2f} s, p90 {np.percentile(lat, 90):.2f} s "
        f"(host clock); steps {steps} ({wall / steps * 1e3:.1f} ms a step), "
        f"compactions {b.compactions - comp0}, prefix hits "
        f"{b.prefix_hits - hits0}; stats() {b.stats()}; peak device memory "
        f"{peak:.2f} GiB")
    if n_tok != BATCH_REQS * BATCH_NEW or [len(o) for o in plain_ids] != [
            BATCH_NEW] * BATCH_REQS:
        raise AssertionError(f"[batch] {n_tok} tokens, not "
                             f"{BATCH_REQS * BATCH_NEW}")
    if b.prefix_hits - hits0 != BATCH_REQS or b.compactions - comp0 < 1:
        raise AssertionError(f"[batch] prefix hits {b.prefix_hits - hits0}, "
                             f"compactions {b.compactions - comp0}")
    want = cfg.num_layers * steps
    log(f"  decode_attn launches {launches} (the batcher's {steps} T = 1 "
        f"steps x {cfg.num_layers} layers = {want}); the first "
        f"{BATCH_ATTN_CHECKS} held to plain, max abs err {attn_err[0]:.3g}")
    if launches != want:
        raise AssertionError(f"[batch] decode_attn launched {launches} "
                             f"times, expected {want}")
    gap, exact = teacher_forced(params, cfg, prompts[:BATCH_CHECKED],
                                plain_ids[:BATCH_CHECKED], dev)
    log(f"  teacher-forced ({BATCH_CHECKED} requests, one solo forward of "
        f"prompt + output each): largest gap to the step's top logit "
        f"{gap:.4f} (tolerance {GEN_LOGIT_ATOL}), argmax at {exact:.1%} of "
        f"steps")
    if not gap <= GEN_LOGIT_ATOL:
        raise AssertionError(f"[batch] teacher-forced gap {gap}")

    # ---- streams: two concurrent streams against two concurrent chats,
    # each pair on a fresh batcher (the same rows and slots, so the same
    # sums)
    async def stream_pair(cs):
        first = []

        async def one(c):
            t0 = time.perf_counter()
            parts = []
            async for d in llm.stream(c, max_tokens=BATCH_STREAM_NEW):
                if not parts:
                    first.append(time.perf_counter() - t0)
                parts.append(d)
            return "".join(parts)

        return await asyncio.gather(*[one(c) for c in cs]), first

    batcher()
    chats = [r.content for r, _ in asyncio.run(
        many(main_convs[:2], max_tokens=BATCH_STREAM_NEW))]
    batcher()
    streamed, ttft = asyncio.run(stream_pair(main_convs[:2]))
    log(f"  streams: 2 at once, {BATCH_STREAM_NEW} new each, texts equal "
        f"to 2 chats at once: {streamed == chats}; time to the first "
        f"streamed token {[round(t, 2) for t in ttft]} s")
    if streamed != chats or not all(chats):
        raise AssertionError("[batch] streamed texts != chat texts")

    # ---- speculation: the same chats through a spec_k batcher
    bs, seen_s = batcher(spec_k=BATCH_SPEC_K)
    t0 = time.perf_counter()
    asyncio.run(many(main_convs, max_tokens=BATCH_NEW))
    torch.cuda.synchronize()
    spec_wall = time.perf_counter() - t0
    spec_ids = [seen_s[(tuple(p), 0)] for p in prompts]
    gap_s, exact_s = teacher_forced(params, cfg, prompts, spec_ids, dev)
    same_s = sum(a == b_ for a, b_ in zip(spec_ids, plain_ids))
    log(f"  speculative batcher (spec_k {BATCH_SPEC_K}): {BATCH_REQS} x "
        f"{BATCH_NEW} in {spec_wall:.2f} s -> "
        f"{sum(map(len, spec_ids)) / spec_wall:.1f} tokens/s; {bs.steps} "
        f"steps ({spec_wall / max(bs.steps, 1) * 1e3:.1f} ms a step) against "
        f"the plain batcher's {steps}, {bs.compactions} compactions, "
        f"stats() {bs.stats()}; teacher-forced gap "
        f"{gap_s:.4f}, argmax at {exact_s:.1%}; {same_s} of {BATCH_REQS} "
        f"equal to the plain batcher's tokens")
    if not gap_s <= GEN_LOGIT_ATOL or [len(o) for o in spec_ids] != [
            BATCH_NEW] * BATCH_REQS:
        raise AssertionError(f"[batch] speculative batcher gap {gap_s}")

    # ---- sampling_ext: constrained chats inside the batch, beside plain
    be, _ = batcher(sampling_ext=True)
    short = [[ChatMessage("user", " ".join(q.split()[:24]))]
             for q in questions[:2 * BATCH_EXT]]
    solo_calls = [0]
    real_gen = llm.generate_ids

    def counted_gen(*a, **kw):
        solo_calls[0] += 1
        return real_gen(*a, **kw)

    async def ext_mix():
        return await asyncio.gather(
            *[llm.chat(c, response_schema=SERVE_SCHEMA,
                       max_tokens=SERVE_SCHEMA_NEW)
              for c in short[:BATCH_EXT]],
            *[llm.chat(c, max_tokens=SERVE_SCHEMA_NEW)
              for c in short[BATCH_EXT:]])

    llm.generate_ids = counted_gen
    try:
        ext = asyncio.run(ext_mix())
    finally:
        del llm.generate_ids
    docs = [json.loads(r.content) for r in ext[:BATCH_EXT]]
    cid = llm._constraint_cid_for(SERVE_SCHEMA)
    log(f"  sampling_ext batcher: {BATCH_EXT} constrained chats beside "
        f"{BATCH_EXT} plain ones in {be.steps} steps, constraint id {cid} "
        f"from the bank ({sum(c is not None for c in be._cslots)} slot "
        f"filled), solo calls {solo_calls[0]}; documents {docs}")
    if (solo_calls[0] or cid != 1 or any(
            set(d) != set(SERVE_SCHEMA["properties"])
            or d["kind"] not in ("alpha", "beta")
            or not isinstance(d["ok"], bool) for d in docs)):
        raise AssertionError(f"[batch] constrained chats {docs}")

    # ---- serialized: BATCH_SOLO of the requests one at a time, solo
    t0 = time.perf_counter()
    solo = [llm.generate_ids(p, max_new=BATCH_NEW)
            for p in prompts[:BATCH_SOLO]]
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    log(f"  serialized: {BATCH_SOLO} solo generate_ids x {BATCH_NEW} new in "
        f"{solo_wall:.2f} s -> {sum(map(len, solo)) / solo_wall:.1f} "
        f"tokens/s, against {n_tok / wall:.1f} batched; "
        f"{sum(a == b_ for a, b_ in zip(solo, plain_ids))} of {BATCH_SOLO} "
        f"equal to the batcher's tokens")

    # ---- solo speculation at B 1, prompt BATCH_SOLO_PROMPT
    long_prompt = (prompts[0] + prompts[1][BATCH_HEADER:]
                   + prompts[2][BATCH_HEADER:])[:BATCH_SOLO_PROMPT]
    t0 = time.perf_counter()
    plain1 = llm.generate_ids(long_prompt, max_new=BATCH_NEW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    spec1 = llm.generate_ids(long_prompt, max_new=BATCH_NEW, speculative=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gap1, exact1 = teacher_forced(params, cfg, [long_prompt], [spec1], dev)
    log(f"  solo speculation, B 1, prompt {len(long_prompt)} + {BATCH_NEW}: "
        f"{t2 - t1:.2f} s against plain generate_ids {t1 - t0:.2f} s; equal "
        f"tokens {spec1 == plain1}; teacher-forced gap {gap1:.4f}, argmax at "
        f"{exact1:.1%}")
    if not gap1 <= GEN_LOGIT_ATOL or len(spec1) != BATCH_NEW:
        raise AssertionError(f"[batch] solo speculation gap {gap1}")
    return launches, attn_err[0]


def train_texts(rng):
    """[train-enc]'s corpus: TRAIN_TEXTS texts of TRAIN_WORDS words drawn
    from a zipf vocabulary of 4,096 words, a sentence end every 8-16."""
    words = [f"w{i}" for i in range(4096)]
    p = zipf_probs(len(words))
    out = []
    for _ in range(TRAIN_TEXTS):
        ws = [words[i] for i in rng.choice(len(words), TRAIN_WORDS, p=p)]
        for j in range(8, TRAIN_WORDS, int(rng.integers(8, 17))):
            ws[j] += "."
        out.append(" ".join(ws))
    return out


def profile_step(label, fn, reps=2):
    """Profile ``reps`` calls of a train step ``fn()``: wall ms (CUDA
    events), device busy ms and idle share, kernel launches and the
    kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
    wall = ev0.elapsed_time(ev1) / reps
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    n = sum(e.count for e in kern) // reps
    log(f"[profile] {label}, mean of {reps}: {wall:.1f} ms wall (CUDA "
        f"events); device busy {busy:.1f} ms ({busy / wall:.1%}), idle "
        f"{1 - busy / wall:.1%}; {n} kernel launches a step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / reps / 1e3:9.3f} ms/step  "
            f"x{e.count // reps:<5d} {e.key[:90]}")


def timed_steps(step, state, n, *args):
    """``n`` calls of a train step on a repeated batch; returns (state,
    losses, host ms a step, each ending in a synchronize)."""
    import torch

    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, *args)
        losses.append(float(m["loss"]))  # reads the loss back: synchronizes
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, losses, ms


def run_train_enc(dev, card):
    """[train-enc]: `make_train_step` on an EncoderConfig() encoder with
    matryoshka dims and AdamW; the card's first step against a CPU copy,
    then TRAIN_STEPS steps on one repeated batch."""
    import torch

    from rag_application_tpu_torch.config import EncoderConfig
    from rag_application_tpu_torch.models import train as tt
    from rag_application_tpu_torch.models import train_data as td
    from rag_application_tpu_torch.models.encoder import init_encoder
    from rag_application_tpu_torch.models.tokenizer import HashTokenizer

    cfg = EncoderConfig()
    rng = np.random.default_rng(11)
    texts = train_texts(rng)
    pairs = td.crop_pairs(texts, rng) + td.keyword_pairs(texts, rng)
    batch = next(td.batches(pairs, HashTokenizer(cfg.vocab_size, TRAIN_LEN),
                            batch_size=TRAIN_BATCH, max_len=TRAIN_LEN))
    log(f"  {len(texts)} texts -> {len(pairs)} pairs (crop + keyword); "
        f"batch {TRAIN_BATCH} x {TRAIN_LEN} tokens, matryoshka dims "
        f"{TRAIN_DIMS}, AdamW lr {TRAIN_ENC_LR}")
    firsts = {}
    for where in ("cpu", dev):
        enc = init_encoder(cfg, device=where)  # seed 0: the same weights
        opt = tt.make_optimizer(lr=TRAIN_ENC_LR)
        step = tt.make_train_step(enc.model, opt, matryoshka_dims=TRAIN_DIMS)
        st = tt.init_train_state(enc.params, opt)
        t0 = time.perf_counter()
        st, m = step(st, batch)
        firsts[str(where)] = (float(m["loss"]),
                              st.params["proj_w"].grad.float().cpu(),
                              time.perf_counter() - t0)
    (lc, gc, tc), (lg, gg, _) = firsts["cpu"], firsts[str(dev)]
    rel = abs(lg - lc) / abs(lc)
    grad_rel = float((gg - gc).norm() / gc.norm())
    log(f"  first step: loss {lg:.6f} on the card, {lc:.6f} on the CPU copy "
        f"({tc:.1f} s), relative {rel:.2e} (tolerance {TRAIN_ENC_LOSS_RTOL});"
        f" proj_w gradient relative L2 {grad_rel:.2e} (tolerance "
        f"{TRAIN_ENC_GRAD_RTOL})")
    if not (rel <= TRAIN_ENC_LOSS_RTOL and grad_rel <= TRAIN_ENC_GRAD_RTOL):
        raise AssertionError(f"[train-enc] card != CPU copy: {rel}, "
                             f"{grad_rel}")
    torch.cuda.reset_peak_memory_stats()
    st, losses, ms = timed_steps(step, st, TRAIN_STEPS, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(ms))
    log(f"  {TRAIN_STEPS} steps on the batch: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step {med:.1f} ms median (host clock, "
        f"synchronized; first {ms[0]:.1f}) -> {TRAIN_BATCH / med * 1e3:,.0f}"
        f" pairs/s; peak device memory {peak:.2f} GiB ({card})")
    if not losses[-1] < losses[0] or not all(map(np.isfinite, losses)):
        raise AssertionError(f"[train-enc] loss did not fall: {losses}")
    profile_step("encoder train step", lambda: step(st, batch))
    return losses, med, peak


def lora_batch(dev, vocab):
    """LORA_B rows of LORA_T tokens, each row cycling through its own
    LORA_PERIOD random tokens of ``vocab`` (a seeded generator): after
    the first period every next token is in the row's context."""
    import torch

    g = torch.Generator().manual_seed(5)
    cycle = torch.randint(7, vocab, (LORA_B, LORA_PERIOD), generator=g)
    ids = cycle[:, torch.arange(LORA_T) % LORA_PERIOD].to(torch.int32)
    return {"ids": ids.to(dev),
            "mask": torch.ones((LORA_B, LORA_T), dtype=torch.bool,
                               device=dev)}


def first_layers(tree, n):
    """A decoder tree (LoRA-wrapped leaves too) cut to its first ``n``
    layers: every stacked per-layer leaf sliced, the rest kept."""
    per_layer = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w_gate",
                 "w_up", "w_down", "bq", "bk", "bv")

    def cut(v):
        return {k: cut(x) for k, x in v.items()} if isinstance(v, dict) \
            else v[:n]
    return {k: cut(v) if k in per_layer else v for k, v in tree.items()}


def on(tree, dev):
    if isinstance(tree, dict):
        return {k: on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_lora_steps(tree, ccfg, batch, dev):
    """The first LORA_CHECK_STEPS steps of `make_lora_train_step` over the
    wrapped ``tree`` on ``dev`` against a CPU copy: each step's loss and
    every adapter factor's gradient. b = 0 at init, so the first step's
    loss is the base's and a's gradient is exactly 0; later steps go
    through the trained rank-r delta. The CPU copy starts each step from
    the card's factors: AdamW's first update is about lr x sign(g), so
    rounding noise in a near-zero gradient flips the sign of that
    element of b, and two runs stepped apart differ by far more than
    their gradients do."""
    import torch

    from rag_application_tpu_torch.models import lora as tl
    from rag_application_tpu_torch.models import train as tt

    runs = []
    for where, t in ((dev, tree), ("cpu", on(tree, "cpu"))):
        opt = tt.make_optimizer(lr=LORA_LR)
        runs.append([tt.init_train_state(tl.lora_adapters(t), opt),
                     tl.make_lora_train_step(ccfg, opt), t,
                     on(batch, where), []])
    tc = 0.0
    for _ in range(LORA_CHECK_STEPS):
        with torch.no_grad():
            for n, ab in runs[1][0].params.items():
                for k, x in ab.items():
                    x.copy_(runs[0][0].params[n][k].cpu())
        for j, r in enumerate(runs):
            t0 = time.perf_counter()
            r[0], m = r[1](r[0], r[2], r[3])
            r[4].append((float(m["loss"]),
                         {f"{n}.{k}": x.grad.float().cpu()
                          for n, ab in r[0].params.items()
                          for k, x in ab.items()}))
            tc += (time.perf_counter() - t0) * j  # the CPU copy's time
    card_steps, cpu_steps = runs[0][4], runs[1][4]

    def grad_rel(g, gc):
        d, n = float((g - gc).norm()), float(gc.norm())
        return d / n if n else (0.0 if d == 0 else float("inf"))

    for i, ((lg, gg), (lc, gc)) in enumerate(zip(card_steps, cpu_steps)):
        rel = abs(lg - lc) / abs(lc)
        errs = {k: grad_rel(gg[k], gc[k]) for k in gc}
        worst = max(errs, key=errs.get)
        zero = sorted(k for k in gc if not gc[k].any() and not gg[k].any())
        log(f"  step {i + 1} at {ccfg.num_layers} layers: loss {lg:.6f} "
            f"on the card, {lc:.6f} on the CPU copy, relative {rel:.2e} "
            f"(tolerance {LORA_LOSS_RTOL}); adapter gradients' worst "
            f"relative L2 {errs[worst]:.2e} ({worst}; tolerance "
            f"{LORA_GRAD_RTOL}); exactly 0 on both: {len(zero)} of "
            f"{len(gc)} leaves")
        if not (rel <= LORA_LOSS_RTOL and errs[worst] <= LORA_GRAD_RTOL):
            raise AssertionError(f"[train-lora] step {i + 1}: card != CPU "
                                 f"copy: loss {rel}, gradients {errs}")
        # b = 0 zeroes a's gradient on the first step, and only there
        want = sorted(k for k in gc if k.endswith(".a")) if i == 0 else []
        if zero != want:
            raise AssertionError(f"[train-lora] step {i + 1}: zero "
                                 f"gradients {zero}, expected {want}")
    log(f"  the CPU copy's {LORA_CHECK_STEPS} steps took {tc:.1f} s")


def run_train_lora(params, cfg, dev, card):
    """[train-lora]: `make_lora_train_step` over [gen-main]'s int8 base
    (kv_quant off for training), then `make_lm_train_step` (bf16 weights,
    a full fine-tune) for FT_STEPS steps. Returns (the trained adapter
    tree, the wrapped tree)."""
    import torch

    from rag_application_tpu_torch.models import decoder as dec
    from rag_application_tpu_torch.models import lora as tl
    from rag_application_tpu_torch.models import train as tt

    tcfg = dataclasses.replace(cfg, kv_quant=False, attn_kernel=False)
    wrapped = tl.lora_init(torch.Generator(device=dev).manual_seed(1),
                           params, r=LORA_R, alpha=LORA_ALPHA)
    batch = lora_batch(dev, cfg.vocab_size)
    ad_bytes = sum(t.numel() * t.element_size()
                   for ab in tl.lora_adapters(wrapped).values()
                   for t in ab.values())
    log(f"  LoRA r {LORA_R}, alpha {LORA_ALPHA} on {tl.DEFAULT_TARGETS}: "
        f"{ad_bytes / 2 ** 20:.2f} MiB of bf16 factors over "
        f"{cfg.num_layers} layers; batch {LORA_B} x {LORA_T} (rows cycling "
        f"through {LORA_PERIOD} tokens), remat, AdamW lr {LORA_LR}")

    check_lora_steps(first_layers(wrapped, LORA_CHECK_LAYERS),
                     dataclasses.replace(tcfg, num_layers=LORA_CHECK_LAYERS),
                     batch, dev)

    opt = tt.make_optimizer(lr=LORA_LR)
    st = tt.init_train_state(tl.lora_adapters(wrapped), opt)
    step = tl.make_lora_train_step(tcfg, opt, remat=True)
    snap = params["wq"]["q"][0, :4, :4].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, losses, ms = timed_steps(step, st, TRAIN_STEPS, wrapped, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(ms))
    log(f"  {TRAIN_STEPS} LoRA steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (must fall below {LORA_DROP} x the first); step "
        f"{med:.1f} ms median (first {ms[0]:.1f}) -> "
        f"{LORA_B * LORA_T / med * 1e3:,.0f} tokens/s; peak device memory "
        f"{peak:.2f} GiB; adapter {ad_bytes / 2 ** 20:.2f} MiB ({card})")
    if not (losses[-1] < LORA_DROP * losses[0]
            and all(map(np.isfinite, losses))):
        raise AssertionError(f"[train-lora] did not overfit: {losses}")
    if not torch.equal(params["wq"]["q"][0, :4, :4], snap):
        raise AssertionError("[train-lora] the frozen base moved")
    profile_step("LoRA train step", lambda: step(st, wrapped, batch))

    # a full fine-tune at the same widths, bf16 weights
    g = torch.Generator(device=dev).manual_seed(0)
    opt = tt.make_optimizer(lr=FT_LR)
    ft = tt.init_train_state(dec.init_decoder_params(g, tcfg, dev), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft, ft_losses, ft_ms = timed_steps(tt.make_lm_train_step(tcfg, opt), ft,
                                       FT_STEPS, batch)
    ft_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  full fine-tune (make_lm_train_step, bf16 weights, remat): loss "
        f"{ft_losses}; step {ft_ms} ms (host clock, synchronized); peak "
        f"device memory {ft_peak:.2f} GiB ({card})")
    if not (all(map(np.isfinite, ft_losses))
            and ft_losses[-1] < ft_losses[0]):
        raise AssertionError(f"[train-lora] full fine-tune: {ft_losses}")
    del ft
    torch.cuda.empty_cache()
    return st.params, wrapped, (losses, med, peak, ad_bytes,
                                ft_losses, ft_ms, ft_peak)


def run_train_serve(params, cfg, adapters, wrapped, dev, card):
    """[train-serve]: the trained adapter saved, registered on a LocalLLM
    over [gen-main]'s weights and flags, and served beside the base in
    one continuous batch at [batch]'s setting. Returns (decode_attn
    launches of the mixed run, max abs err of its checked launches)."""
    import asyncio
    import os
    import shutil

    import torch

    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage
    from rag_application_tpu_torch.models import lora as tl
    from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer
    from rag_application_tpu_torch.ops import decode_attn as da

    os.makedirs(TSERVE_DIR, exist_ok=True)
    path = f"{TSERVE_DIR}/adapter.npz"
    try:
        tl.save_adapters(adapters, path, wrapped=wrapped)
        words = serve_vocab(cfg.vocab_size)
        tok = WordPieceTokenizer.from_vocab_list(words, max_len=cfg.max_len)
        # eos unreachable, as in [batch]: [SEP]'s LM-head column scaled to 0
        sep = words.index("[SEP]")
        head = {"q": params["lm_head"]["q"],
                "s": params["lm_head"]["s"].clone()}
        head["s"][sep] = 0.0
        base = {**params, "lm_head": head}
        llm = LocalLLM(base, cfg, tok, model_name="tinyllama-1.1b-random",
                       device=dev)
        if llm.register_lora("smoke", path) != 1:
            raise AssertionError("[train-serve] bank index")
        merged = tl.lora_merge(tl.lora_wrap_with(
            base, tl.load_adapters(path, device=dev)))
    finally:
        shutil.rmtree(TSERVE_DIR, ignore_errors=True)
    rng = np.random.default_rng(17)
    header, questions = batch_header_and_questions(rng, TSERVE_CONVS, words)
    convs = [[ChatMessage("system", header), ChatMessage("user", q)]
             for q in questions]
    prompts = [llm.render(c) for c in convs]

    def batcher():
        b = llm.enable_batching(slots=BATCH_SLOTS, prompt_pad=BATCH_PROMPT,
                                horizon=BATCH_HORIZON, chunk=BATCH_CHUNK,
                                lookahead=BATCH_LOOKAHEAD)
        return b, record_ids(b)

    async def chats(adapters_):
        return await asyncio.gather(*[
            llm.chat(c, max_tokens=TSERVE_NEW, **({"adapter": a} if a else {}))
            for a in adapters_ for c in convs])

    real_attn = da.decode_attend_int8
    attn_err = [0.0]

    def attn_checked(*args):
        out = real_attn(*args)
        if attn_checked.launches <= BATCH_ATTN_CHECKS:
            plain = da.decode_attend_int8_plain(*args)
            err = (out.float() - plain.float()).abs().max().item()
            if err > 2 * bf16_ulp(plain.float().abs().max().item()):
                raise AssertionError(f"[train-serve] decode_attn != plain: "
                                     f"{err}")
            attn_err[0] = max(attn_err[0], err)
        return out

    attn_checked.launches = 0
    b, seen = batcher()
    da.decode_attend_int8 = attn_checked
    try:
        t0 = time.perf_counter()
        res = asyncio.run(chats([None, "smoke"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        da.decode_attend_int8 = real_attn
    launches, steps = attn_checked.launches, b.steps
    n_tok = sum(r.usage["completion_tokens"] for r in res)
    base_ids = [seen[(tuple(p), 0)] for p in prompts]
    lora_ids = [seen[(tuple(p), 1)] for p in prompts]
    log(f"  {2 * TSERVE_CONVS} chats at once ({TSERVE_CONVS} with the "
        f"adapter, {TSERVE_CONVS} without), {TSERVE_NEW} new each: "
        f"{wall:.2f} s -> {n_tok / wall:.1f} tokens/s; steps {steps}; "
        f"decode_attn launches {launches} ({cfg.num_layers} layers x "
        f"{steps} steps), the first {BATCH_ATTN_CHECKS} held to plain, max "
        f"abs err {attn_err[0]:.3g} ({card})")
    if n_tok != 2 * TSERVE_CONVS * TSERVE_NEW:
        raise AssertionError(f"[train-serve] {n_tok} tokens")
    if launches != cfg.num_layers * steps:
        raise AssertionError(f"[train-serve] decode_attn launched "
                             f"{launches} times in {steps} steps")
    gap_l, exact_l = teacher_forced(merged, cfg, prompts, lora_ids, dev)
    gap_b, exact_b = teacher_forced(base, cfg, prompts, base_ids, dev)
    differ = sum(a != b_ for a, b_ in zip(lora_ids, base_ids))
    log(f"  teacher-forced: adapter rows on the lora_merge'd bf16 weights "
        f"gap {gap_l:.4f}, argmax at {exact_l:.1%}; base rows on the base "
        f"gap {gap_b:.4f}, argmax at {exact_b:.1%} (tolerance "
        f"{GEN_LOGIT_ATOL}); the adapter changed {differ} of "
        f"{TSERVE_CONVS} outputs")
    if not (gap_l <= GEN_LOGIT_ATOL and gap_b <= GEN_LOGIT_ATOL):
        raise AssertionError(f"[train-serve] teacher-forced gaps {gap_l}, "
                             f"{gap_b}")
    if differ != TSERVE_CONVS:
        raise AssertionError("[train-serve] the adapter left an output as "
                             "the base's")
    del merged
    # the base rows alone, on a fresh batcher: the same tokens
    b, seen_alone = batcher()
    asyncio.run(chats([None]))
    alone = [seen_alone[(tuple(p), 0)] for p in prompts]
    log(f"  base rows without the adapter rows beside them: equal tokens "
        f"{alone == base_ids}")
    if alone != base_ids:
        raise AssertionError("[train-serve] base rows depend on the "
                             "adapter rows")
    return launches, attn_err[0]


def train_phase(params, cfg, dev, card):
    """[train-enc], [train-lora], [train-serve], each logged with its
    time; returns `run_train_serve`'s."""
    import torch

    t0 = time.perf_counter()
    log(f"[train-enc] make_train_step, EncoderConfig() ({card})")
    run_train_enc(dev, card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log(f"[train-lora] make_lora_train_step over [gen-main]'s int8 base, "
        f"TinyLlama-1.1B widths ({card})")
    adapters, wrapped, _ = run_train_lora(params, cfg, dev, card)
    t2 = time.perf_counter()
    log(f"[train-serve] the trained adapter through LocalLLM.register_lora "
        f"and the continuous batcher ({card})")
    out = run_train_serve(params, cfg, adapters, wrapped, dev, card)
    del adapters, wrapped
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"[train] {t3 - t0:.1f} s: enc {t1 - t0:.1f}, lora {t2 - t1:.1f}, "
        f"serve {t3 - t2:.1f}")
    return out


def ann_corpus(dev):
    """[ann]'s corpus, made on the card from a seeded generator:
    ANN_N rows, each one of ANN_TRUE N(0, 1) centres plus ANN_NOISE
    N(0, 1), inserted through `DenseIndex.insert` in ANN_CHUNK-row
    chunks (examples/tune_ivf.py's corpus and index). Every insert's
    prep launch is held against plain in the index's planes. Returns
    (the index, the insert prep launches)."""
    import torch

    from rag_application_tpu_torch.config import IndexConfig
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.ops import quant as oq

    gen = torch.Generator(device=dev).manual_seed(ANN_SEED)
    centres = torch.randn((ANN_TRUE, DIM), generator=gen, device=dev)
    dense = idense.DenseIndex(IndexConfig(
        dim=DIM, matryoshka_dims=(128, 256), initial_capacity=1 << 20),
        device=dev)
    oq.prepare_vectors_into.launches = 0
    with recording(idense, "prepare_vectors_into") as preps:
        for s in range(0, ANN_N, ANN_CHUNK):
            m = min(ANN_CHUNK, ANN_N - s)
            a = torch.randint(0, ANN_TRUE, (m,), generator=gen, device=dev)
            dense.insert(centres[a] + ANN_NOISE * torch.randn(
                (m, DIM), generator=gen, device=dev))
    launches = oq.prepare_vectors_into.launches
    torch.cuda.synchronize()
    shapes = check_preps("[ann] corpus inserts", preps)
    if len(preps) != launches or shapes != {
            (ANN_CHUNK, (128, 256)): -(-ANN_N // ANN_CHUNK)}:
        raise AssertionError(f"[ann] {launches} prep launches, "
                             f"{len(preps)} recorded, by shape {shapes}")
    return dense, launches


@contextlib.contextmanager
def build_split(log_):
    """While the block runs, `index/ivf.py`'s k-means, assignment and
    slab gather run synchronized and append (name, s) to ``log_``."""
    import torch

    from rag_application_tpu_torch.index import ivf as tivf

    real = {n: getattr(tivf, n) for n in ("_kmeans", "_assign",
                                           "_gather_buckets")}

    def timed_(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            log_.append((name, time.perf_counter() - t0))
            return out
        return run

    for n, fn in real.items():
        setattr(tivf, n, timed_(n, fn))
    try:
        yield log_
    finally:
        for n, fn in real.items():
            setattr(tivf, n, fn)


def cpu_ivf(ivf):
    """The same IVF index over CPU copies of its tables and its dense
    index's planes."""
    import copy

    import torch

    from rag_application_tpu_torch.index.dense import DenseIndex
    from rag_application_tpu_torch.index.ivf import IVFIndex

    dense = copy.copy(ivf.dense)
    dense.device = torch.device("cpu")
    for name in DenseIndex._PLANES:
        t = getattr(dense, name)
        setattr(dense, name, None if t is None else t.cpu())
    out = IVFIndex(dense, ivf.centroids.cpu(), ivf.bucket_cluster.cpu(),
                   ivf.bucket_tbl.cpu(), ivf.bucket_rowids.cpu(),
                   built_n=ivf.built_n, bucket_rows=ivf.bucket_rows,
                   rebuild_threshold=ivf.rebuild_threshold)
    out._build_kw = dict(ivf._build_kw)
    return out


def bits_equal(a, b) -> bool:
    """Equal tensors, bit for bit (floats by their bits), on the CPU."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def rescored_agree(ids_a, vals_a, ids_b, vals_b, tol) -> bool:
    """Rescored top-k lists of one query from two devices: scores within
    ``tol`` and ids equal but where two candidates' scores are within
    2 ``tol`` (the card and the CPU sum an f32 dot in different
    orders)."""
    ids_a, ids_b = list(ids_a), list(ids_b)
    if len(ids_a) != len(ids_b) or any(
            abs(x - y) > tol for x, y in zip(vals_a, vals_b)):
        return False
    for p, (x, y) in enumerate(zip(ids_a, ids_b)):
        if x != y:
            other = (vals_b[ids_b.index(x)] if x in ids_b else vals_b[-1])
            if abs(other - vals_b[p]) > 2 * tol:
                return False
    return True


def run_ann(col, emb, tokens, dev):
    """[ann]: the IVF engine at the repo's ANN configuration, then
    through the API's path on the [ingest] collection. Returns the prep
    launches of the corpus's inserts."""
    import os

    import torch

    from rag_application_tpu_torch.index.ivf import IVFIndex, IVFSearchParams

    t0 = time.perf_counter()
    dense, preps = ann_corpus(dev)
    torch.cuda.synchronize()
    log(f"  corpus {dense.size:,} x {DIM} ({ANN_TRUE} centres, noise "
        f"{ANN_NOISE}) made and inserted in {time.perf_counter() - t0:.3f} s, "
        f"{preps} prep launches ({ANN_N // ANN_CHUNK} inserts), each "
        f"bit-equal to plain")

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    split = []
    with build_split(split):
        t0 = time.perf_counter()
        ivf = IVFIndex.build(dense, n_clusters=ANN_CLUSTERS,
                             bucket_rows=ANN_BUCKET, iters=ANN_ITERS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    parts = dict(split)
    parts["host (sample, reorder)"] = build_s - sum(parts.values())
    build_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    tables = (torch.cuda.memory_allocated() - base) / 2**30
    log(f"  IVFIndex.build(n_clusters={ANN_CLUSTERS}, bucket_rows="
        f"{ANN_BUCKET}, iters={ANN_ITERS}): {build_s:.2f} s "
        f"({ {k: round(v, 3) for k, v in parts.items()} } s); "
        f"{ivf.bucket_tbl.shape[0]:,} buckets of {ANN_BUCKET} rows "
        f"({ivf.bucket_tbl.numel() / 2**30:.2f} GiB slab table), peak "
        f"{build_peak:.2f} GiB above the dense index")
    rid = ivf.bucket_rowids.cpu().numpy()
    live = rid[rid >= 0]
    if len(live) != dense.size or len(np.unique(live)) != dense.size:
        raise AssertionError("[ann] the buckets do not cover every row once")

    rng = np.random.default_rng(ANN_SEED)
    rows = torch.from_numpy(rng.choice(dense.size, ANN_BATCH,
                                       replace=False)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(ANN_SEED + 1)
    q = dense.vecs[rows].float() + 0.05 * torch.randn(
        (ANN_BATCH, DIM), generator=gen, device=dev)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    exact = exact_top_ids(dense, q[:N_EVAL], K)

    torch.cuda.reset_peak_memory_stats()
    sweep = {}
    for probes in ANN_PROBES:
        params = IVFSearchParams(probes=probes, rescore_limit=ANN_RESCORE)
        _, ids = ivf.search(q, K, params=params)
        ids = ids.cpu().numpy()
        recall = float(np.mean([np.isin(exact[i], ids[i]).mean()
                                for i in range(N_EVAL)]))
        ms = cuda_ms(lambda: ivf.search(q, K, params=params), reps=5)
        sweep[probes] = (ms, recall)
        log(f"  probes {probes:3d}: {ms:8.3f} ms per batch of {ANN_BATCH} "
            f"(CUDA events, warm) -> {ANN_BATCH / ms * 1e3:,.0f} queries/s; "
            f"recall@10 vs exact (bf16 plane) on {N_EVAL} queries "
            f"{recall:.4f}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 - tables
    params = IVFSearchParams(probes=128, rescore_limit=ANN_RESCORE)
    times = kernel_times(lambda: ivf.search(q, K, params=params), 3)
    busy = sum(ms * n for ms, n in times.values())
    log(f"[profile] one batch at probes 128: device busy {busy:.3f} ms of "
        f"{sweep[128][0]:.3f} ms; by kernel (ms a batch, launches):")
    for name, (ms, n) in sorted(times.items(),
                                key=lambda t: -t[1][0] * t[1][1])[:6]:
        log(f"  {ms * n:9.3f} ms  x{n:<5.1f} {name[:90]}")
    log(f"  peak device memory above the tables during the sweep "
        f"{peak:.2f} GiB (tables: the slab table, ids and centroids "
        f"{tables:.2f} GiB, beside the dense index)")
    low, high = sweep[ANN_PROBES[0]][1], sweep[ANN_PROBES[-1]][1]
    if low < 0.95 or high < low:
        raise AssertionError(f"[ann] recall@10 {sweep}")

    # the card against the same index on CPU copies of its tables: ids
    # and int8-stage scores bit for bit
    t0 = time.perf_counter()
    cpu = cpu_ivf(ivf)
    qs = q[:ANN_CPU_QUERIES]
    for probes in (32, 128):
        params = IVFSearchParams(probes=probes, rescore=False)
        dv, di = ivf.search(qs, K, params=params)
        cv, ci = cpu.search(qs.cpu(), K, params=params)
        if not (bits_equal(di, ci) and bits_equal(dv, cv)):
            raise AssertionError(f"[ann] probes {probes}: the card's ids or "
                                 f"int8-stage scores differ from the CPU's")
    log(f"  {ANN_CPU_QUERIES} queries at probes 32 and 128, int8 stage: ids "
        f"and scores bit-equal to the same index on CPU copies "
        f"({time.perf_counter() - t0:.1f} s)")
    del cpu

    # a save and a load answer bit for bit
    os.makedirs(os.path.dirname(ANN_FILE), exist_ok=True)
    ivf.save(ANN_FILE)
    restored = IVFIndex.load(ANN_FILE, dense)
    params = IVFSearchParams(probes=64)
    a, b = ivf.search(q, K, params=params), restored.search(q, K,
                                                            params=params)
    size = os.path.getsize(ANN_FILE)
    os.remove(ANN_FILE)
    os.rmdir(os.path.dirname(ANN_FILE))
    if not (bits_equal(a[0], b[0]) and bits_equal(a[1], b[1])):
        raise AssertionError("[ann] the loaded index answers otherwise")
    log(f"  save ({size / 2**20:.1f} MiB) and load: {ANN_BATCH} queries at "
        f"probes 64 answered bit for bit")
    del ivf, restored, dense, q, a, b
    torch.cuda.empty_cache()

    # the API's path: /admin/build-ann, then /api/v1/search/ann
    t0 = time.perf_counter()
    col.build_ann()
    torch.cuda.synchronize()
    api_build = time.perf_counter() - t0
    log(f"  Collection.build_ann() over {col.dense.size:,} chunks "
        f"({col.chunk_count():,} live): {api_build:.2f} s, "
        f"{col.ann.bucket_tbl.shape[0]:,} buckets, "
        f"{col.ann.centroids.shape[0]} clusters")
    live_rows = np.nonzero(col.dense.live[:col.dense.size].cpu().numpy())[0]
    src = rng.choice(live_rows, ANN_API_QUERIES, replace=False)
    texts = noisy_texts(tokens, src % len(tokens), 961)
    vecs = emb.encode(texts)
    docs = [col.payloads.get(int(r))["document_id"] for r in src]
    exact = exact_top_ids(col.dense, torch.from_numpy(vecs).to(dev), K,
                          live_only=True)
    cpu = cpu_ivf(col.ann)
    # rescored scores within 1e-6, the CPU parity tests' tolerance (the
    # worst case of two f32 dots summed in other orders, 2 d 2^-24, is
    # 9.16e-5; the gap read is logged)
    tol = 1e-6
    gap = 0.0  # the largest card-vs-CPU gap between two scores in place
    for filtered in (False, True):
        ms, hits = [], []
        for v, doc in zip(vecs, docs):
            kw = {"document_id": doc} if filtered else {}
            t1 = time.perf_counter()
            hits.append(col.ann_search(v, limit=K, ef=ANN_API_EF, **kw))
            ms.append((time.perf_counter() - t1) * 1e3)
        found = np.mean([int(r) in [h.row for h in hs]
                         for r, hs in zip(src, hits)])
        empty = sum(not hs for hs in hits)
        recall = "" if filtered else (
            "; recall@10 vs exact (live rows) " + format(np.mean(
                [np.isin(exact[i], [h.row for h in hs]).mean()
                 for i, hs in enumerate(hits)]), ".4f"))
        log(f"  {ANN_API_QUERIES} single queries, ann_search(limit={K}, "
            f"ef={ANN_API_EF}){' with a document_id filter' * filtered}: "
            f"p50 {np.percentile(ms, 50):.2f} ms, p90 "
            f"{np.percentile(ms, 90):.2f} ms (host clock, hits joined to "
            f"payloads); the source chunk among the hits for {found:.1%}"
            f"{recall}; {empty} with no hit")
        for v, doc, hs in zip(vecs, docs, hits):
            mask = (col.payloads.filter_mask(col.dense.capacity,
                                             document_id=doc)
                    if filtered else None)
            cv, ci = cpu.search(v[None, :], K, params=IVFSearchParams(
                probes=ANN_API_EF), filter_mask=mask)
            keep = np.isfinite(cv[0].numpy())
            want_ids = [int(i) for i in ci[0].numpy()[keep]]
            want_vals = [float(x) for x in cv[0].numpy()[keep]]
            got = ([h.row for h in hs], [h.score for h in hs])
            # a filtered query finds nothing when no probed bucket holds
            # a row of its document (the filter applies after the probe)
            if (not hs and not filtered) or not rescored_agree(
                    *got, want_ids, want_vals, tol):
                raise AssertionError(f"[ann] ann_search hits differ from "
                                     f"the CPU run's (filtered {filtered}): "
                                     f"card {got}, CPU {want_ids} "
                                     f"{want_vals}")
            gap = max([gap] + [abs(x - y) for x, y in zip(got[1], want_vals)])
            if filtered and any(h.payload["document_id"] != doc for h in hs):
                raise AssertionError("[ann] a filtered hit from another "
                                     "document")
    log(f"  every hit list equal to the same index's on CPU copies (rows "
        f"but at near-ties, scores within {tol:.3g}); largest score gap "
        f"{gap:.3g}")
    del cpu
    col.ann = None
    torch.cuda.empty_cache()
    return preps


def agent_sheet(kg, emb):
    """A structured sheet in the KG (a CSV's upsert), so the table tools
    have columns and values to read."""
    cities = ["lyon", "oslo", "quito", "perth", "kyoto", "lagos", "bern",
              "lima"]
    columns = [{"name": "name", "profile": "person names"},
               {"name": "city", "profile": "city of residence"},
               {"name": "team", "profile": "team the person works in"}]
    rows = [{"name": f"person {i}", "city": cities[i % len(cities)],
             "team": f"team {i % 3}"} for i in range(16)]
    kg.upsert_document(AGENT_SHEET, {"title": "People", "kind": "csv",
                                     "rows": len(rows)})
    kg.upsert_structured_sheet(
        AGENT_SHEET, 1, sheet_name="people", summary="a table of people",
        summary_embedding=emb.encode(["a table of people"])[0][:kg.dim],
        columns=columns,
        column_embeddings=emb.encode([c["profile"] for c in columns])[
            :, :kg.dim],
        rows=rows)


def agent_tool_args(col, kg, texts):
    """Real arguments for each tool of the toolbox, drawn from the
    stores: a page of [kg], an entity of it with a neighbour, a stored
    chunk, the sheet of `agent_sheet`."""
    from rag_application_tpu_torch.kg.store import Space

    table = kg.spaces[Space.ENTITY]
    doc = next(d for d in kg.documents if kg.get_entities(d))
    ent = next(e for e in kg.get_entities(doc)
               if any(kg.entity_edges.get(r)
                      for _, r in table.rows_for_id(e["id"])))
    row = next(r for _, r in table.rows_for_id(ent["id"])
               if kg.entity_edges.get(r))
    other = table.get(kg.entity_edges[row][0][1])["id"]
    chunk_row = int(np.nonzero(col.dense.live.cpu().numpy())[0][100])
    chunk = col.payloads.get(chunk_row)
    query = texts[0]
    return {
        "search_documents": {"query": doc},
        "list_documents": {},
        "get_document_metadata": {"document_id": AGENT_SHEET},
        "list_document_pages": {"document_id": doc},
        "get_page_content": {"document_id": doc, "page_number": 1},
        "search_pages_semantic": {"query": query},
        "search_entities_semantic": {"query": ent["text"]},
        "search_relationships_semantic": {"query": f"{ent['text']} and "
                                                   f"{other}"},
        "search_columns_semantic": {"query": "city of residence"},
        "search_across_spaces": {"query": ent["text"], "k": 10},
        "hybrid_search": {"query": query},
        "get_entity_by_id": {"entity_id": ent["id"]},
        "find_entities_by_type": {"entity_type": ent["entity_type"]},
        "get_entity_context": {"entity_id": ent["id"]},
        "traverse_entity_graph": {"entity_id": ent["id"], "hops": 2,
                                  "query": query},
        "path_between_entities": {"source_id": ent["id"],
                                  "target_id": other},
        "get_relationships_between": {"source_id": ent["id"],
                                      "target_id": other},
        "get_column_values": {"column_name": "city"},
        "search_row_values": {"value": "lyon"},
        "get_chunk_neighbors": {"document_id": chunk["document_id"],
                                "chunk_index": chunk["chunk_index"]},
        "structured_query": {"operation": "stats"},
    }


def run_agents(col, emb, kg, tokens, dev):
    """[agents]: every tool of the knowledge toolbox once, AGENT_TURNS
    `KnowledgeSearchAgent` turns on a STUB router (one at a time, then
    AGENT_CONCURRENCY at a time), a `DeepResearchAgent` run, each over
    the [ingest] collection and the [kg] graph with memories on the
    card. Returns ((int8 scan, bf16 scan, bm25) max abs errors of the
    recorded launches, the phase's launches by kernel entry, its prep
    launches)."""
    import asyncio

    import torch

    from rag_application_tpu_torch.agents.chat_agent import \
        KnowledgeSearchAgent
    from rag_application_tpu_torch.agents.deep_research import \
        DeepResearchAgent
    from rag_application_tpu_torch.agents.memory import (ThreadCheckpointer,
                                                         VectorMemoryStore)
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.llm.router import LLMRouter, Provider
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops import quant as oq
    from rag_application_tpu_torch.tools.knowledge import \
        KnowledgeSearchToolbox

    agent_sheet(kg, emb)
    toolbox = KnowledgeSearchToolbox(col, kg, emb).build()
    rng = np.random.default_rng(73)
    live = np.nonzero(col.dense.live[:col.dense.size].cpu().numpy())[0]
    texts = noisy_texts(tokens, rng.choice(live, AGENT_TURNS + 1,
                                           replace=False) % len(tokens), 977)
    args = agent_tool_args(col, kg, texts)
    if sorted(args) != toolbox.names():
        raise AssertionError(f"[agents] tools {toolbox.names()}")

    # every scan and match launch of the phase (tools, turns one at a
    # time, research, turns run concurrently) is recorded and held against
    # plain
    with recording(ft, "scan_sheet") as scans, \
            recording(ob, "bm25_match_rows") as matches:
        reset_scan_counts(ft)
        ob.bm25_match_rows.launches = 0
        oq.prepare_vectors_into.launches = 0
        tool_ms = {}
        for name in toolbox.names():
            ms = []
            for _ in range(2):  # the first call may build a cached table
                t0 = time.perf_counter()
                out = asyncio.run(toolbox.get(name).call(**args[name]))
                ms.append(round((time.perf_counter() - t0) * 1e3, 2))
            tool_ms[name] = ms
            if not out or (isinstance(out, dict) and "error" in out):
                raise AssertionError(f"[agents] {name}({args[name]}) -> {out}")
            if name == "path_between_entities" and not out["reachable"]:
                raise AssertionError(f"[agents] {name} -> {out}")
        log(f"  every tool of KnowledgeSearchToolbox(col, kg, emb), real "
            f"arguments, ms of a first and a second call (host clock): "
            f"{tool_ms}")

        store = VectorMemoryStore(emb)
        if store.device != col.device:
            raise AssertionError(f"[agents] memories on {store.device}")
        agent = KnowledgeSearchAgent(LLMRouter(Provider.STUB), toolbox=toolbox,
                                     memory_store=store, reflections=True,
                                     user_id="smoke",
                                     checkpointer=ThreadCheckpointer())
        inputs = [f"use {AGENT_TOOLS[i % len(AGENT_TOOLS)]} {texts[i + 1]}"
                  for i in range(AGENT_TURNS)]
        puts = []
        real_put, real_insert = store.put, idense.DenseIndex.insert

        def put(*a, **k):
            puts.append(a[1])
            return real_put(*a, **k)

        inserted = []

        def insert(self, x):
            inserted.append(len(x))
            return real_insert(self, x)

        async def one(i, tag):
            t0 = time.perf_counter()
            out = await agent.ainvoke(inputs[i], thread_id=f"{tag}-{i}")
            return out, (time.perf_counter() - t0) * 1e3

        async def in_turn():
            # the first turn's memory write (its reflection drained at once,
            # before a later put tombstones its row) is held against plain
            with recording(idense, "prepare_vectors_into") as preps:
                res = [await one(0, "seq")]
                await agent.drain_reflections()
            first.update(check_preps("[agents] the first turn's memory put",
                                     preps))
            for i in range(1, AGENT_TURNS):
                res.append(await one(i, "seq"))
            await agent.drain_reflections()
            return res

        async def together():
            sem = asyncio.Semaphore(AGENT_CONCURRENCY)

            async def limited(i):
                async with sem:
                    return await one(i, "par")
            res = await asyncio.gather(*(limited(i)
                                         for i in range(AGENT_TURNS)))
            await agent.drain_reflections()
            return res

        store.put = put
        idense.DenseIndex.insert = insert
        first = {}
        try:
            t0 = time.perf_counter()
            seq = asyncio.run(in_turn())
            seq_s = time.perf_counter() - t0
        finally:
            idense.DenseIndex.insert = real_insert
        mem_preps = oq.prepare_vectors_into.launches
        turn_ms = np.array([m for _, m in seq])
        calls = [sum(len(m.get("tool_calls") or []) for m in o["messages"])
                 for o, _ in seq]
        log(f"  {AGENT_TURNS} KnowledgeSearchAgent turns one at a time (STUB "
            f"router, 'use <tool> <text>', reflections on): p50 "
            f"{np.percentile(turn_ms, 50):.1f} ms, p90 "
            f"{np.percentile(turn_ms, 90):.1f} ms a turn, {seq_s:.2f} s in all; "
            f"{sum(calls)} tool calls ({calls[0]} a turn); memory puts "
            f"{len(puts)}, DenseIndex inserts {len(inserted)} "
            f"({sum(inserted)} rows), prep launches {mem_preps}")
        if (mem_preps != len(inserted) or len(puts) < AGENT_TURNS
                or first != {(1, ()): 1} or sum(inserted) < len(puts)):
            raise AssertionError(f"[agents] prep launches {mem_preps}, inserts "
                                 f"{len(inserted)}, puts {len(puts)}")
        for (o, _), text in zip(seq, inputs):
            tools_msgs = [m for m in o["messages"] if m["role"] == "tool"]
            if not tools_msgs or not o["content"].startswith("[stub]") or any(
                    m["content"].startswith('{"error"') for m in tools_msgs):
                raise AssertionError(f"[agents] turn {text[:40]!r}: "
                                     f"{o['messages'][-1]}")

        # a DeepResearchAgent run over the real toolbox, scripted as
        # tests/test_deep_research.py scripts it
        research = LLMRouter(Provider.STUB)
        rounds = {"n": 0}

        def gap(_):
            rounds["n"] += 1
            return json.dumps({"gap_exists": rounds["n"] <= 2,
                               "missing": "details about the topic"})

        research.stub.on(r"research contract", lambda _: json.dumps({
            "needs_clarification": False,
            "contract": ["what the corpus says", "who is named"]}))
        research.stub.on(r"Does a gap remain", gap)
        research.stub.on(r"search subqueries", lambda _: json.dumps(
            {"subqueries": [texts[0], args["search_entities_semantic"]["query"]]}))
        research.stub.on(r"Write a dense factual finding",
                         lambda p: "finding: " + p[10:90])
        research.stub.on(r"final research report", lambda p: "REPORT " + p[:60])
        rstore = VectorMemoryStore(emb)
        before = scan_counts(ft)
        t0 = time.perf_counter()
        out = asyncio.run(DeepResearchAgent(
            research, toolbox=toolbox, research_store=rstore,
            max_iterations=3).ainvoke("what does the corpus say",
                                      thread_id="research"))
        research_s = time.perf_counter() - t0
        findings = rstore.list(("research", "research"))
        log(f"  DeepResearchAgent: {out['status']}, {out['iterations']} "
            f"iterations, trace {out['trace']}, {len(findings)} findings in "
            f"{research_s * 1e3:.1f} ms")
        if (out["status"] != "complete" or not out["content"].startswith("REPORT")
                or out["trace"][-1]["open_gaps"] or not findings
                or scan_counts(ft) == before):
            raise AssertionError(f"[agents] research {out}")
        launches = {**scan_counts(ft),
                    "bm25_match": ob.bm25_match_rows.launches}
        preps_all = oq.prepare_vectors_into.launches
        recorded = (len(scans), len(matches))
        if (ft.route_launches["fused_scan"] or not all(launches.values())
                or recorded[0] < launches["fused_scan"]
                + launches["fused_scan_bf16"]
                or recorded[1] < launches["bm25_match"]):
            raise AssertionError(f"[agents] launches {launches}, by kernel "
                                 f"{ft.route_launches}, recorded calls "
                                 f"{recorded}")

        # the turns again, AGENT_CONCURRENCY at a time
        t0 = time.perf_counter()
        par = asyncio.run(together())
        par_s = time.perf_counter() - t0
        store.put = real_put
    par_ms = np.array([m for _, m in par])
    log(f"  the {AGENT_TURNS} turns {AGENT_CONCURRENCY} at a time "
        f"(asyncio.gather): p50 {np.percentile(par_ms, 50):.1f} ms, p90 "
        f"{np.percentile(par_ms, 90):.1f} ms a turn, {par_s:.2f} s in all "
        f"({seq_s:.2f} s one at a time)")
    for (a, _), (b, _) in zip(seq, par):
        if a["messages"] != b["messages"]:
            raise AssertionError("[agents] a turn run concurrently differs "
                                 "from the same turn run alone")
    errs = check_recorded("[agents] tools, turns and research",
                          routed(scans), matches, each=False)
    log(f"  launches (tools, turns one at a time, research) {launches}, "
        f"from {recorded[0]} scan and {recorded[1]} match calls, each held "
        f"to plain above with the concurrent turns' ({len(scans)} scans, "
        f"{len(matches)} matches in all); prep {preps_all} (memory and "
        f"research puts)")
    return errs, launches, preps_all


# ------------------------------------------------------------------ [serve]

def serve_vocab(size):
    """The generation vocabulary of [gen-main], with single-byte ``##``
    pieces for every printable ASCII byte, so that the response schemas'
    grammars compile (`compile_schema` refuses a vocabulary that cannot
    spell ``{``); the rest as in `run_local_llm`."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ":", "user", "assistant"]
    words += [f"##{chr(c)}" for c in range(0x20, 0x7F)]
    words += [f"w{i}" if i % 2 else f"##p{i}"
              for i in range(size - len(words))]
    return words


class ServerThread:
    """An `HTTPServer` on its own event loop in a thread of this process
    (port 0: the OS picks one)."""

    def __init__(self, router):
        import asyncio
        import threading

        from rag_application_tpu_torch.api.http import HTTPServer

        self.loop = asyncio.new_event_loop()
        self.server = HTTPServer(router, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)

    def start(self) -> int:
        import asyncio

        self.thread.start()
        return asyncio.run_coroutine_threadsafe(
            self.server.start(), self.loop).result(60)

    def stop(self) -> None:
        """Stop serving, cancel the loop's other tasks (the micro-batchers'
        loops), stop and close the loop."""
        import asyncio

        async def shutdown():
            await self.server.stop()
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()


def http_call(port, method, path, body=None, *, timeout=600):
    """One request by the standard library's client (one connection,
    closed after it): (status, parsed JSON or text, host ms)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={
            "content-type": "application/json", "connection": "close"})
        r = conn.getresponse()
        raw = r.read()
        ctype = r.getheader("content-type", "")
    finally:
        conn.close()
    ms = (time.perf_counter() - t0) * 1e3
    out = json.loads(raw) if ctype.startswith("application/json") else \
        raw.decode()
    return r.status, out, ms


def http_sse(port, path, body, *, timeout=600):
    """A streamed request: the parsed ``data:`` events up to [DONE], and
    host ms."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    events = []
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"content-type": "application/json"})
        r = conn.getresponse()
        if r.status != 200 or not r.getheader(
                "content-type", "").startswith("text/event-stream"):
            raise AssertionError(f"[serve] {path}: {r.status} {r.read()!r}")
        while True:
            line = r.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data:"):
                continue
            data = line[5:].strip()
            if data == "[DONE]":
                break
            events.append(json.loads(data))
    finally:
        conn.close()
    return events, (time.perf_counter() - t0) * 1e3


def serve_checkpoint(col, kg, emb, dev):
    """Save the [ingest] collection and the [kg] graph as one user space
    through the port's `serve.checkpoint_spaces`, with an account beside
    them, under SERVE_DIR (emptied first). Returns (directory, the saved
    user ids, the account's username, seconds, MB on disk)."""
    import os
    import shutil

    from rag_application_tpu_torch.api.app import UserSpace, build_app
    from rag_application_tpu_torch.config import Config
    from rag_application_tpu_torch.llm.router import LLMRouter, Provider
    from rag_application_tpu_torch.serve import checkpoint_spaces

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SERVE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    _, st = build_app(Config(), llm=LLMRouter(Provider.STUB), embedder=emb,
                      device=dev)
    uid = col.name[len("user_"):]
    st.users[uid] = UserSpace(col, kg, st.make_pipeline(uid, col, kg))
    st.user_registry.signup("smoke-admin", "smoke-password")
    t0 = time.perf_counter()
    saved = checkpoint_spaces(st, os.path.join(root, "spaces"), {})
    secs = time.perf_counter() - t0
    if saved != [uid]:
        raise AssertionError(f"[serve] checkpoint_spaces saved {saved}")
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)
    return os.path.join(root, "spaces"), saved, "smoke-admin", secs, size / 1e6


def serve_hits_close(got, want, label):
    """Hit lists (score, payload) from the API against the same search
    run directly: the same payloads, scores within 1e-6, but where two
    hits within 1e-6 of each other swap places."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} hits, {len(want)} direct")
    for i, (g, w) in enumerate(zip(got, want)):
        if abs(g[0] - w[0]) > 1e-6:
            raise AssertionError(f"{label}: hit {i} score {g[0]} != {w[0]}")
        if g[1] != w[1]:
            tied = [x for x in want if abs(x[0] - g[0]) <= 1e-6]
            if g[1] not in [x[1] for x in tied]:
                raise AssertionError(f"{label}: hit {i} differs: "
                                     f"{g[1]} != {w[1]}")


def run_serve(emb, dev, gen, ckpt):
    """[serve]: the port's HTTP service on the card. `build_app` with a
    LOCAL router (TinyLlama-1.1B widths, the [gen-main] weights and
    flags, `serve_vocab`, generation capped at SERVE_NEW tokens where a
    request names no limit, one structured attempt), `serve.restore_spaces`
    from ``ckpt``, the search MCP server at /mcp, an `HTTPServer` on port
    0 in a thread; then every route of SERVE_* by the standard library's
    client, each route's answers checked and its launches counted, every
    scan, match and prep launch held to plain; then the server as its own
    process. Returns ((int8 scan, bf16 scan, bm25) max abs errors,
    launches by kernel entry, the decode attention's max abs error)."""
    import asyncio
    import os
    import signal
    import socket
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rag_application_tpu_torch.api.app import build_app
    from rag_application_tpu_torch.config import Config
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import LLMRouter, Provider
    from rag_application_tpu_torch.mcp.search_server import SearchMCPServer
    from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import decode_attn as da
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops import quant as oq
    from rag_application_tpu_torch.serve import restore_spaces
    from rag_application_tpu_torch.tools.mcp_client import MCPClient

    ckpt_dir, saved_users, account, _, _ = ckpt
    params, gcfg = gen
    tok = WordPieceTokenizer.from_vocab_list(serve_vocab(gcfg.vocab_size),
                                             max_len=gcfg.max_len)
    local = LocalLLM(params, gcfg, tok, model_name="tinyllama-1.1b-random",
                     device=dev)

    class CappedRouter(LLMRouter):
        """The LOCAL router with SERVE_NEW new tokens where a call names no
        limit (the orchestrator's and the agent's calls)."""

        async def chat(self, messages, **params):
            if not params.get("max_tokens"):
                params["max_tokens"] = SERVE_NEW
            return await super().chat(messages, **params)

    llm = CappedRouter(Provider.LOCAL, local=local, model=local.model_name,
                       max_retries=1)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    router, st = build_app(Config(), llm=llm, embedder=emb, device=dev)
    restored = restore_spaces(st, ckpt_dir)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored != saved_users or not any(
            u["username"] == account for u in st.user_registry.list()):
        raise AssertionError(f"[serve] restored {restored} (saved "
                             f"{saved_users}), accounts "
                             f"{st.user_registry.list()}")
    uid = restored[0]
    sp = st.users[uid]
    if sp.collection.device != dev or sp.kg.device != dev:
        raise AssertionError("[serve] restored stores off the card")
    chunks0 = sp.collection.chunk_count()
    log(f"  build_app + restore_spaces: {restore_s:.2f} s, user {uid!r} "
        f"({chunks0:,} chunks, KG {sp.kg.stats()}), account {account!r}")
    mcp = SearchMCPServer(sp.collection, sp.kg, emb)
    mcp.attach_http(router)
    srv = ServerThread(router)
    port = srv.start()
    rng = np.random.default_rng(101)
    live = np.nonzero(sp.collection.dense.live[:sp.collection.dense.size]
                      .cpu().numpy())[0]
    stored = [sp.collection.payloads.get(int(r))["text"]
              for r in rng.choice(live, SERVE_SEARCHES, replace=False)]
    words = [t.split() for t in stored]
    queries = [" ".join(w[j] if rng.random() > TOK_FLIP
                        else f"w{rng.integers(0, VOCAB)}" for j in range(len(w)))
               for w in words]

    # decode attention: the first SERVE_ATTN_CHECKS launches held to plain
    # as they happen (the cache is written in place after each)
    real_attn = da.decode_attend_int8
    attn_err = [0.0]

    def attn_checked(*args):
        out = real_attn(*args)
        if attn_checked.launches <= SERVE_ATTN_CHECKS:
            plain = da.decode_attend_int8_plain(*args)
            err = (out.float() - plain.float()).abs().max().item()
            if err > 2 * bf16_ulp(plain.float().abs().max().item()):
                raise AssertionError(f"[serve] decode_attn != plain: {err}")
            attn_err[0] = max(attn_err[0], err)
        return out

    attn_checked.launches = 0
    inserts = [0]
    real_insert = idense.DenseIndex.insert

    def counting_insert(self, x):
        inserts[0] += 1
        return real_insert(self, x)

    def counts():
        return {**scan_counts(ft), "bm25_match": ob.bm25_match_rows.launches,
                "prep_vectors": oq.prepare_vectors_into.launches,
                "decode_attn": da.decode_attend_int8.launches}

    routes = {}   # route -> {"ms": [...], "launches": {...}}

    def route(name, fn):
        before = counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        after = counts()
        entry = routes.setdefault(name, {"ms": [], "launches": {},
                                         "wall_s": 0.0})
        for k in after:
            entry["launches"][k] = (entry["launches"].get(k, 0)
                                    + after[k] - before[k])
        entry["wall_s"] += wall
        return out

    def call(name, method, path, body=None, want=200):
        status, out, ms = http_call(port, method, path, body)
        if status != want:
            raise AssertionError(f"[serve] {method} {path}: {status} {out}")
        routes.setdefault(name, {"ms": [], "launches": {}, "wall_s": 0.0})
        routes[name]["ms"].append(ms)
        return out

    server_proc = logf = None
    try:
        with recording(ft, "scan_sheet") as scans, \
                recording(ob, "bm25_match_rows") as matches:
            reset_scan_counts(ft)
            ob.bm25_match_rows.launches = 0
            oq.prepare_vectors_into.launches = 0
            da.decode_attend_int8 = attn_checked
            idense.DenseIndex.insert = counting_insert
            try:
                health = route("GET /health",
                               lambda: call("GET /health", "GET", "/health"))
                models = route("GET /v1/models", lambda: call(
                    "GET /v1/models", "GET", "/v1/models"))
                metrics = route("GET /metrics", lambda: call(
                    "GET /metrics", "GET", "/metrics"))
                if (health != {"status": "ok", "users": 1}
                        or models["data"][0]["id"] != local.model_name
                        or not isinstance(metrics, str)):
                    raise AssertionError(f"[serve] {health} {models}")
                ref_query = queries[0]
                ref = route("POST /api/v1/search/hybrid", lambda: call(
                    "POST /api/v1/search/hybrid", "POST",
                    "/api/v1/search/hybrid",
                    {"query": ref_query, "user_id": uid, "limit": K}))
                # held to plain now: the ingests below write the planes
                # and the live mask that its recorded inputs point at
                ref_errs = check_recorded("[serve] the search before the "
                                          "ingests", routed(scans), matches,
                                          each=False)
                del scans[:], matches[:]

                # ingest: the prep launches are the inserts; the first
                # document's held to plain in place
                docs = [" ".join(words[i % len(words)] * 3)
                        for i in range(SERVE_INGESTS)]
                with recording(idense, "prepare_vectors_into") as preps:
                    first = route("POST /ingest/raw-text", lambda: call(
                        "POST /ingest/raw-text", "POST", "/ingest/raw-text",
                        {"text": docs[0], "document_id": "serve-doc-0",
                         "user_id": uid}, want=202))
                preps_first = check_preps("[serve] the first ingest", preps)
                for i in range(1, SERVE_INGESTS):
                    route("POST /ingest/raw-text", lambda i=i: call(
                        "POST /ingest/raw-text", "POST", "/ingest/raw-text",
                        {"text": docs[i], "document_id": f"serve-doc-{i}",
                         "user_id": uid}, want=202))
                ing = routes["POST /ingest/raw-text"]["launches"]
                if (ing["prep_vectors"] != inserts[0] or not first["chunks"]
                        or not preps_first):
                    raise AssertionError(f"[serve] ingest: prep launches "
                                         f"{ing['prep_vectors']}, inserts "
                                         f"{inserts[0]}")

                # 64 searches, SERVE_CONCURRENCY at once (the micro-batcher)
                def search(q):
                    return call("POST /api/v1/search/hybrid", "POST",
                                "/api/v1/search/hybrid",
                                {"query": q, "user_id": uid, "limit": K})

                # the first search after the ingests rebuilds BM25's device
                # tables; the 64 are timed after it
                rebuild = route("POST /api/v1/search/hybrid",
                                lambda: search(queries[-1]))
                rebuild_ms = routes["POST /api/v1/search/hybrid"]["ms"][-1]
                t0 = time.perf_counter()
                with ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
                    answers = route("POST /api/v1/search/hybrid", lambda: list(
                        pool.map(search, queries)))
                search_rps = SERVE_SEARCHES / (time.perf_counter() - t0)
                for q in queries[:SERVE_SCOUTS]:
                    route("POST /search/scout", lambda q=q: call(
                        "POST /search/scout", "POST", "/search/scout",
                        {"query": q, "user_id": uid, "k": K}))

                # LOCAL generation: a finite response_format schema
                schema = SERVE_SCHEMA
                gen_tokens = [0]
                for i in range(SERVE_CHATS):
                    out = route("POST /v1/chat/completions", lambda i=i: call(
                        "POST /v1/chat/completions", "POST",
                        "/v1/chat/completions",
                        {"messages": [{"role": "user",
                                       "content": f"classify {queries[i]}"}],
                         "max_tokens": SERVE_SCHEMA_NEW,
                         "response_format": {"type": "json_schema",
                                             "json_schema": {
                                                 "schema": schema}}}))
                    doc = json.loads(out["choices"][0]["message"]["content"])
                    if (set(doc) != set(schema["properties"])
                            or doc["kind"] not in ("alpha", "beta")
                            or not isinstance(doc["ok"], bool)):
                        raise AssertionError(f"[serve] structured {doc}")
                    gen_tokens[0] += out["usage"]["completion_tokens"]
                key = local._schema_key(schema)
                if (local._constraint_cache.get(key) is None
                        or key not in local._constraint_dev):
                    raise AssertionError("[serve] the schema's constraint "
                                         "did not compile")
                asks = []
                for i in range(SERVE_ASKS):
                    asks.append(route("POST /api/v1/query/ask",
                                      lambda i=i: call(
                        "POST /api/v1/query/ask", "POST",
                        "/api/v1/query/ask",
                        {"question": queries[i], "user_id": uid})))
                if not all(a["sources"] and isinstance(a["answer"], str)
                           for a in asks):
                    raise AssertionError(f"[serve] ask {asks[0]}")
                streamed = []
                for i in range(SERVE_STREAMS):
                    def one(i=i):
                        events, ms = http_sse(port, "/chat/completions", {
                            "user": uid, "stream": True, "messages": [
                                {"role": "user", "content": queries[i]}]})
                        routes.setdefault(
                            "POST /chat/completions (stream)",
                            {"ms": [], "launches": {}, "wall_s": 0.0}
                        )["ms"].append(ms)
                        return events
                    events = route("POST /chat/completions (stream)", one)
                    text = "".join(e["choices"][0]["delta"].get("content", "")
                                   for e in events)
                    if (not text
                            or events[-1]["choices"][0]["finish_reason"]
                            != "stop"):
                        raise AssertionError(f"[serve] stream {events[-2:]}")
                    streamed.append(text)
                texts = [queries[i] for i in range(SERVE_EMBED)]
                vecs = route("POST /v1/embeddings", lambda: call(
                    "POST /v1/embeddings", "POST", "/v1/embeddings",
                    {"input": texts}))
                got = np.asarray([d["embedding"] for d in vecs["data"]],
                                 np.float32)
                if not np.array_equal(got, emb.encode(texts)):
                    raise AssertionError("[serve] /v1/embeddings != "
                                         "Embedder.encode")

                # admin checkpoint, restore under a new id, same answers
                apath = os.path.join(os.path.dirname(ckpt_dir), "admin")
                saved = route("POST /admin/checkpoint", lambda: call(
                    "POST /admin/checkpoint", "POST", "/admin/checkpoint",
                    {"user_id": uid, "path": apath}))
                back = route("POST /admin/restore", lambda: call(
                    "POST /admin/restore", "POST", "/admin/restore",
                    {"user_id": uid + "-restored", "path": apath}))
                if back["chunks"] != saved["chunks"] or back["kg"] != \
                        saved["kg"]:
                    raise AssertionError(f"[serve] restore {back} != {saved}")
                for q in queries[:SERVE_SCOUTS]:
                    a, b = (route("POST /api/v1/search/hybrid (restored)",
                                  lambda u=u: call(
                                      "POST /api/v1/search/hybrid (restored)",
                                      "POST", "/api/v1/search/hybrid",
                                      {"query": q, "user_id": u,
                                       "limit": K}))
                            for u in (uid, uid + "-restored"))
                    if a != b:
                        raise AssertionError("[serve] the restored space "
                                             "answers otherwise")

                # the search MCP server over HTTP and in process
                tools = route("POST /mcp", lambda: call(
                    "POST /mcp", "POST", "/mcp",
                    {"jsonrpc": "2.0", "id": 1, "method": "tools/list"}))
                margs = {"query": queries[1], "k": K}
                over_http = route("POST /mcp", lambda: call(
                    "POST /mcp", "POST", "/mcp",
                    {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                     "params": {"name": "hybrid_search",
                                "arguments": margs}}))
                client = MCPClient()
                client.add_inprocess("search", mcp)
                in_proc = route("MCP in process", lambda: asyncio.run(
                    client.call("search", "hybrid_search", margs)))
                names = [t["name"] for t in tools["result"]["tools"]]
                if (len(names) < 21 or "hybrid_search" not in names
                        or json.loads(over_http["result"]["content"][0]
                                      ["text"]) != in_proc or not in_proc):
                    raise AssertionError("[serve] MCP over HTTP != in process")
                totals = counts()
            finally:
                da.decode_attend_int8 = real_attn
                idense.DenseIndex.insert = real_insert
            peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30

            # the API's hits against Collection.hybrid_search run directly
            for i, (q, a) in enumerate(zip(queries, answers)):
                direct = sp.collection.hybrid_search(emb.encode([q])[0], q,
                                                     limit=K)
                serve_hits_close([(h["score"], h["payload"])
                                  for h in a["results"]],
                                 [(h.score, h.payload) for h in direct],
                                 f"[serve] search {i}")
        errs = tuple(map(max, zip(ref_errs, check_recorded(
            "[serve] every route after the ingests", routed(scans), matches,
            each=False))))
        launches = {k: sum(r["launches"].get(k, 0) for r in routes.values())
                    for k in totals}
        if launches != totals or not all(launches.values()):
            raise AssertionError(f"[serve] launches by route {launches}, in "
                                 f"all {totals}")

        # the server as its own process, from the same checkpoint
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            sub_port = s.getsockname()[1]
        env = dict(os.environ, RAGTPU_CHECKPOINT_DIR=ckpt_dir,
                   RAGTPU_PORT=str(sub_port), RAGTPU_HOST="127.0.0.1",
                   RAGTPU_LLM_PROVIDER="stub",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        env.pop("RAGTPU_PLATFORM", None)
        logf = open(os.path.join(os.path.dirname(ckpt_dir), "server.log"),
                    "w")
        t0 = time.perf_counter()
        server_proc = subprocess.Popen(
            [sys.executable, "-m", "rag_application_tpu_torch.serve"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=logf, stderr=subprocess.STDOUT)
        while True:
            try:
                status, h, _ = http_call(sub_port, "GET", "/health",
                                         timeout=5)
                break
            except OSError:
                if server_proc.poll() is not None or \
                        time.perf_counter() - t0 > SERVE_BOOT_S:
                    logf.flush()
                    with open(logf.name) as f:
                        tail = f.read()[-2000:]
                    raise AssertionError(f"[serve] the server process did "
                                         f"not answer: {tail}")
                time.sleep(0.25)
        boot_s = time.perf_counter() - t0
        _, cols, _ = http_call(sub_port, "GET", "/api/v1/collections")
        _, sub_ref, _ = http_call(sub_port, "POST", "/api/v1/search/hybrid",
                                  {"query": ref_query, "user_id": uid,
                                   "limit": K})
        if (h != {"status": "ok", "users": len(saved_users)}
                or [c["user_id"] for c in cols["collections"]]
                != saved_users
                or cols["collections"][0]["chunks"] != chunks0):
            raise AssertionError(f"[serve] server process: {h}, {cols}")
        serve_hits_close([(x["score"], x["payload"]) for x in
                          sub_ref["results"]],
                         [(x["score"], x["payload"]) for x in ref["results"]],
                         "[serve] the server process's search")
    finally:
        if server_proc is not None:
            server_proc.send_signal(signal.SIGTERM)
            try:
                server_proc.wait(30)
            except subprocess.TimeoutExpired:
                server_proc.kill()
                server_proc.wait()
        if logf is not None:
            logf.close()
        srv.stop()

    def pct(ms, p):
        return f"{np.percentile(ms, p):.1f}"

    for name, r in routes.items():
        took = {k: v for k, v in r["launches"].items() if v}
        if r["ms"]:
            log(f"  {name}: {len(r['ms'])} requests, p50 {pct(r['ms'], 50)} "
                f"ms, p90 {pct(r['ms'], 90)} ms (host clock); launches "
                f"{took}")
        else:
            log(f"  {name}: {r['wall_s'] * 1e3:.1f} ms; launches {took}")
    chat_s = routes["POST /v1/chat/completions"]["wall_s"]
    log(f"  searches: the first after the ingests {rebuild_ms:.1f} ms (BM25's "
        f"device tables rebuilt, {len(rebuild['results'])} hits), then "
        f"{SERVE_SEARCHES} requests {SERVE_CONCURRENCY} at once, "
        f"{search_rps:.1f} requests/s, hits equal to Collection.hybrid_search"
        f" (scores within 1e-6); structured chats: {gen_tokens[0]} tokens in "
        f"{chat_s:.2f} s ({gen_tokens[0] / chat_s:.1f} generated tokens/s, "
        f"constrained, schema-valid); asks {SERVE_ASKS}, streams "
        f"{SERVE_STREAMS} ({[len(t) for t in streamed]} chars); MCP "
        f"{len(names)} tools, equal over HTTP and in process")
    log(f"  the server process: /health after {boot_s:.2f} s (restore of "
        f"{saved_users} included), its search equal to the in-process one; "
        f"in-process restore {restore_s:.2f} s; peak device memory above "
        f"the weights and stores {peak:.2f} GiB; launches {launches}; "
        f"decode_attn first {SERVE_ATTN_CHECKS} held to plain (max abs err "
        f"{attn_err[0]:.3g})")
    return errs, launches, attn_err[0]


# ------------------------------------------------------------------ [media]

def media_images(rng, n, h=MEDIA_SIZE // 8, w=MEDIA_SIZE // 8):
    """``n`` generated images as (n, h, w, 3) float32 blocks in [0, 1],
    each block pixel an 8 x 8 square of the raster (`media_raster`): a
    base colour, a plane wave of random frequency, phase and contrast,
    and block noise of random strength. Photos differ in such global
    statistics; i.i.d. random blocks would all pool to nearly one
    vector (cosine ~0.998 between any two on the random tower)."""
    yy, xx = np.mgrid[0:h, 0:w]
    xx, yy = xx[..., None] / w, yy[..., None] / h
    base = rng.random((n, 1, 1, 3))
    contrast = rng.uniform(0.05, 0.5, (n, 1, 1, 1))
    fx, fy = rng.uniform(0.5, 4.0, (2, n, 1, 1, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3))
    wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
    noise = rng.uniform(0, 0.5, (n, 1, 1, 1)) * (rng.random((n, h, w, 3))
                                                 - 0.5)
    return np.clip(base + contrast * wave + noise, 0, 1).astype(np.float32)


def media_raster(blocks):
    """(n, h, w, 3) blocks -> (n, 8 h, 8 w, 3) float32 rasters."""
    return np.repeat(np.repeat(blocks, 8, axis=1), 8, axis=2)


def media_clips(rng, n):
    """``n`` generated log-mel clips (n, 256, 128): smooth (32 x 16 blocks)
    plus fine noise, normalized per clip as `audio.wav_to_features`
    normalizes."""
    low = rng.standard_normal((n, 32, 16)).astype(np.float32)
    x = np.repeat(np.repeat(low, 8, axis=1), 8, axis=2)
    x += 0.1 * rng.standard_normal(x.shape, dtype=np.float32)
    mu = x.mean(axis=(1, 2), keepdims=True)
    sd = x.std(axis=(1, 2), keepdims=True)
    return (x - mu) / sd


def media_captions(rng, n):
    """``n`` captions of MEDIA_CAPTION zipf words ([ingest]'s vocabulary)."""
    return [" ".join(f"w{t}" for t in row)
            for row in synth_tokens(rng, n, doc_len=MEDIA_CAPTION)]


def media_pcm(rng, seconds=2.56, sr=16000):
    """A mono 16-bit clip: two tones (100-4,000 Hz) and a little noise."""
    t = np.arange(int(seconds * sr)) / sr
    f = rng.uniform(100, 4000, 2)
    x = 0.3 * np.sin(2 * np.pi * f[0] * t) + 0.2 * np.sin(2 * np.pi * f[1] * t)
    x += 0.02 * rng.standard_normal(len(t))
    return (x * 32767).astype(np.int16)


def media_wav(pcm, sr=16000):
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def media_avi(frames, w, h, usec=40_000):
    """An MJPEG AVI of JPEG ``frames``: tests/test_video.py's layout (RIFF
    'AVI ', an hdrl list with avih and one vids/MJPG stream header, a
    movi list of 00dc chunks)."""
    import struct

    def chunk(fourcc, payload):
        pad = b"\x00" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(list_type, inner):
        return chunk(b"LIST", list_type + inner)

    avih = struct.pack("<IIIIIIIIIIIIII", usec, 0, 0, 0x10, len(frames),
                       0, 1, 0, w, h, 0, 0, 0, 0)
    strh = b"vids" + b"MJPG" + b"\x00" * 48
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", f) for f in frames))
    body = b"AVI " + hdrl + movi
    return b"RIFF" + struct.pack("<I", len(body)) + body


def media_files(rng):
    """The files of [media]'s pipeline leg, made with the port's own
    encoders: (kind, name, bytes, chunks expected)."""
    from rag_application_tpu_torch.ingest.flac import encode_flac
    from rag_application_tpu_torch.ingest.pdf import _make_png
    from rag_application_tpu_torch.models.jpeg import encode_jpeg

    def photo(h, w):
        img = media_raster(media_images(rng, 1, h // 8, w // 8))[0]
        return np.round(img * 255).astype(np.uint8)

    files = []
    for i in range(MEDIA_PNG):
        img = photo(240, 320)
        files.append(("png", f"scan-{i}.png",
                      _make_png(img.tobytes(), 320, 240, 8, "rgb"), 1))
    for i in range(MEDIA_JPEG):
        files.append(("jpeg", f"photo-{i}.jpg",
                      encode_jpeg(photo(192, 256), quality=90), 1))
    for i in range(MEDIA_WAV):
        files.append(("wav", f"memo-{i}.wav", media_wav(media_pcm(rng)), 1))
    for i in range(MEDIA_FLAC):
        files.append(("flac", f"track-{i}.flac",
                      encode_flac(media_pcm(rng).astype(np.int64), 16000), 1))
    frames = [encode_jpeg(photo(240, 320), quality=85)
              for _ in range(MEDIA_FRAMES)]
    # extract_frames samples at most 8 frames of a video (its default)
    files.append(("mjpeg", "walkthrough.avi", media_avi(frames, 320, 240),
                  min(MEDIA_FRAMES, 8)))
    return files


def check_media_tower(emb):
    """[media-check]: the card's tower against a CPU copy with the same
    weights (`init_encoder` draws them from a CPU generator), through
    `encode_image` / `encode_audio` at the Embedder's batch with a padded
    tail, image and audio alone and with captions. Pooled rows must be
    unit vectors within cosine MEDIA_COS of the CPU's. Returns the max
    abs error."""
    import torch

    from rag_application_tpu_torch.config import EncoderConfig
    from rag_application_tpu_torch.models.embedder import Embedder
    from rag_application_tpu_torch.models.encoder import init_encoder

    t0 = time.perf_counter()
    cs = init_encoder(EncoderConfig(), seed=0, multimodal=True, device="cpu")
    same = all(torch.equal(t.cpu(), cs.params[n])
               for n, t in emb.state.params.items())
    if not same or set(cs.params) != set(emb.state.params):
        raise AssertionError("[media-check] the CPU copy's weights differ")
    emb = Embedder(emb.state, tokenizer=emb.tokenizer, max_len=emb.max_len,
                   batch_size=MEDIA_CHECK_BATCH)
    cpu = Embedder(cs, max_len=emb.max_len, batch_size=4)
    rng = np.random.default_rng(41)
    n = MEDIA_CHECK_N
    imgs = media_raster(media_images(rng, n))
    clips = media_clips(rng, n)
    caps = media_captions(rng, n)
    worst = 0.0
    for label, fn, x, texts in (
            ("image", "encode_image", imgs, None),
            ("audio", "encode_audio", clips, None),
            ("image + caption", "encode_image", imgs, caps),
            ("audio + caption", "encode_audio", clips, caps)):
        got = getattr(emb, fn)(x, texts=texts)
        want = getattr(cpu, fn)(x, texts=texts)
        cos = (got * want).sum(-1)
        err = float(np.abs(got - want).max())
        norms = np.linalg.norm(got, axis=-1)
        log(f"  {label}: {n} rows (batches of {emb.batch_size}, the tail "
            f"padded): cosine to the CPU copy min {cos.min():.6f}, max abs "
            f"err {err:.3g}, norms {norms.min():.6f}-{norms.max():.6f}")
        if (not np.isfinite(got).all() or cos.min() < MEDIA_COS
                or np.abs(norms - 1).max() > 1e-4):
            raise AssertionError(f"[media-check] {label}: card != CPU copy")
        worst = max(worst, err)
    # a padded batch: rows with zero media and no caption keep their patch
    # tokens valid (all-true media masks) and must stay finite
    model = emb.state.model
    ids, mask = emb.tokenizer.encode_batch([""] * emb.batch_size, emb.max_len)
    dev = emb.device
    x = torch.zeros(emb.batch_size, model.image_size, model.image_size, 3,
                    device=dev)
    x[:2] = torch.from_numpy(imgs[:2]).to(dev)
    a = torch.zeros(emb.batch_size, model.audio_frames, model.audio_mels,
                    device=dev)
    pooled, tokens = model.apply(
        None, torch.from_numpy(ids).to(dev),
        torch.zeros(mask.shape, dtype=torch.bool, device=dev), x, None, a,
        return_tokens=True)
    if not (torch.isfinite(pooled).all() and torch.isfinite(tokens).all()):
        raise AssertionError("[media-check] padded rows are not finite")
    log(f"  a padded batch (2 images, {emb.batch_size - 2} zero rows, zero "
        f"clips, no captions): pooled and {tuple(tokens.shape)} token "
        f"outputs finite; the check took {time.perf_counter() - t0:.1f} s")
    return worst


def media_direct(emb, col, rng):
    """Direct encodes: MEDIA_IMAGES images through `encode_image` and
    MEDIA_CLIPS clips through `encode_audio`, MEDIA_BATCH at a time, each
    batch stored into ``col`` as one document (an image's payload text is
    its caption, for the BM25 leg); the first documents' prep launches
    held to plain. Returns (image blocks, captions, image rows, prep
    launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.ops import quant as oq

    blocks = media_images(rng, MEDIA_IMAGES)
    caps = media_captions(rng, MEDIA_IMAGES)
    clips = media_clips(rng, MEDIA_CLIPS)
    emb.encode_image(media_raster(blocks[:MEDIA_BATCH]))  # warm-up
    emb.encode_audio(clips[:MEDIA_BATCH])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oq.prepare_vectors_into.launches = 0
    oq.prepare_vectors.launches = 0
    enc = {"image": 0.0, "audio": 0.0}
    store_s, rows, docs, preps = 0.0, [], 0, []
    for kind, n in (("image", MEDIA_IMAGES), ("audio", MEDIA_CLIPS)):
        for b in range(0, n, MEDIA_BATCH):
            sl = slice(b, b + MEDIA_BATCH)
            if kind == "image":
                x = media_raster(blocks[sl])
                t0 = time.perf_counter()
                vecs = emb.encode_image(x)
                chunks = [{"text": caps[i], "source": "image", "index": i}
                          for i in range(b, b + len(x))]
            else:
                t0 = time.perf_counter()
                vecs = emb.encode_audio(clips[sl])
                chunks = [{"text": f"[audio] clip {i}", "source": "audio",
                           "index": i} for i in range(b, b + len(vecs))]
            t1 = time.perf_counter()
            enc[kind] += t1 - t0
            if docs < MEDIA_HELD:
                with recording(idense, "prepare_vectors_into") as one:
                    r = col.store_document_vectors(f"{kind}-album-{b}",
                                                   chunks, vecs)
                preps += one
            else:
                r = col.store_document_vectors(f"{kind}-album-{b}", chunks,
                                               vecs)
            store_s += time.perf_counter() - t1
            docs += 1
            if kind == "image":
                rows += r
    launches = oq.prepare_vectors_into.launches
    shapes = check_preps(f"[media] the first {MEDIA_HELD} albums", preps)
    log(f"  encode_image: {MEDIA_IMAGES:,} images in "
        f"{enc['image']:.2f} s -> {MEDIA_IMAGES / enc['image']:,.1f} "
        f"images/s; encode_audio: {MEDIA_CLIPS:,} clips in "
        f"{enc['audio']:.2f} s -> {MEDIA_CLIPS / enc['audio']:,.1f} clips/s "
        f"(host clock, batches of {MEDIA_BATCH}, the host's raster "
        f"expansion outside the clock)")
    log(f"  store_document_vectors: {docs} albums of {MEDIA_BATCH} in "
        f"{store_s:.2f} s; prepare_vectors_into launches {launches} (one a "
        f"document: {docs}), prepare_vectors {oq.prepare_vectors.launches}; "
        f"held to plain {shapes}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != docs or oq.prepare_vectors.launches \
            or set(shapes) != {(MEDIA_BATCH, PREP_DIMS)}:
        raise AssertionError(f"[media] {launches} prep launches for {docs} "
                             f"documents")
    x = media_raster(blocks[:MEDIA_BATCH])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        emb.encode_image(x)
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] one encode_image batch ({MEDIA_BATCH} images, "
        f"{MEDIA_BATCH} x {196 + emb.max_len} tokens): {wall:.2f} ms wall "
        f"(host clock); device busy {busy:.2f} ms ({busy / wall:.1%}), idle "
        f"{1 - busy / wall:.1%}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    return blocks, caps, rows, launches


def media_pipeline(emb, col, kg, rng, dev):
    """The pipeline leg: `media_files` through `IngestPipeline` as
    `api/app.py` wires it (`IngestConfig()`, the KG, no describer), one
    kind after another with IngestConfig().max_concurrency uploads in
    flight; the first file alone, its prep launches held to plain.
    Returns (the files, prep launches)."""
    import asyncio

    import torch

    from rag_application_tpu_torch.config import IngestConfig
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.ingest.pipeline import IngestPipeline
    from rag_application_tpu_torch.ops import quant as oq

    t0 = time.perf_counter()
    files = media_files(rng)
    cfg = IngestConfig()
    pipe = IngestPipeline(col, emb, kg=kg, config=cfg)
    log(f"  set-up {time.perf_counter() - t0:.1f} s: {MEDIA_PNG} PNG "
        f"(320 x 240), {MEDIA_JPEG} baseline JPEG (256 x 192), {MEDIA_WAV} "
        f"WAV and {MEDIA_FLAC} FLAC (2.56 s, 16 kHz, 16-bit), one MJPEG AVI "
        f"of {MEDIA_FRAMES} frames (320 x 240); {cfg.max_concurrency} "
        f"uploads in flight, max_concurrency {cfg.max_concurrency}")
    calls = {"encode_image": [], "encode_audio": [], "store": [], "kg": []}

    def clock(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            calls[key].append(time.perf_counter() - t)
            return out
        setattr(obj, name, wrapper)

    clock(emb, "encode_image", "encode_image")
    clock(emb, "encode_audio", "encode_audio")
    clock(col, "store_document_vectors", "store")
    clock(kg, "upsert_unstructured_page", "kg")

    async def upload(batch):
        sem = asyncio.Semaphore(cfg.max_concurrency)

        async def one(name, data):
            async with sem:
                return name, await pipe.ingest_file(name, data,
                                                    document_id=name)
        return dict(await asyncio.gather(*(one(n, d) for _, n, d, _ in batch)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    oq.prepare_vectors_into.launches = 0
    oq.prepare_vectors.launches = 0
    with recording(idense, "prepare_vectors_into") as preps:
        results = asyncio.run(upload(files[:1]))
    kinds = {}
    for f in files[1:]:
        kinds.setdefault(f[0], []).append(f)
    by_kind = {}
    for kind, batch in kinds.items():
        t1 = time.perf_counter()
        results.update(asyncio.run(upload(batch)))
        torch.cuda.synchronize()
        by_kind[kind] = (len(batch), sum(f[3] for f in batch),
                         time.perf_counter() - t1)
    launches = oq.prepare_vectors_into.launches
    shapes = check_preps(f"[media] the first file ({files[0][1]})", preps)
    del emb.encode_image, emb.encode_audio, col.store_document_vectors, \
        kg.upsert_unstructured_page
    for kind, (n, chunks, secs) in by_kind.items():
        log(f"  {kind}: {n} files, {chunks} chunks in {secs:.2f} s -> "
            f"{n / secs:,.2f} documents/s, {chunks / secs:,.1f} chunks/s")
    total = sum(v[2] for v in by_kind.values())
    n_chunks = sum(f[3] for f in files)
    log(f"  all but the first file: {len(files) - 1} files in {total:.2f} s "
        f"-> {(len(files) - 1) / total:.2f} documents/s, "
        f"{(n_chunks - files[0][3]) / total:,.1f} chunks/s")
    for key, ts in calls.items():
        if ts:
            log(f"  {key} a task (host clock, ms): mean "
                f"{np.mean(ts) * 1e3:.2f}, median {np.median(ts) * 1e3:.2f}, "
                f"p90 {np.percentile(ts, 90) * 1e3:.2f} ({len(ts)} calls)")
    failed = [(t.task_type.value, t.error) for t in pipe.queue.failed]
    wrong = {}
    for kind, name, _, want in files:
        r = results[name]
        rows = col.payloads.rows_where(document_id=name)
        texts = sorted(col.payloads.get(x)["text"] for x in rows)
        expect = (sorted(f"[image] page {p}" for p in range(1, want + 1))
                  if kind in ("png", "jpeg", "mjpeg") else [f"[audio] {name}"])
        if (r.chunks, r.failed_tasks) != (want, 0) or texts != expect:
            wrong[name] = (r, texts[:2])
    image_pages = sum(f[3] for f in files if f[0] in ("png", "jpeg", "mjpeg"))
    log(f"  failed ledger {failed}; files with their expected chunks and "
        f"texts {len(files) - len(wrong)} of {len(files)}; prep launches "
        f"{launches} = Collection inserts {n_chunks} + KG page rows "
        f"{image_pages}: {launches == n_chunks + image_pages}; "
        f"prepare_vectors {oq.prepare_vectors.launches}; held to plain "
        f"{shapes}; KG {kg.stats()}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if failed or wrong or launches != n_chunks + image_pages \
            or oq.prepare_vectors.launches or len(calls["kg"]) != image_pages \
            or len(calls["store"]) != n_chunks \
            or set(shapes) != {(1, PREP_DIMS), (1, ())}:
        raise AssertionError(f"[media] pipeline: failed {failed}, wrong "
                             f"{wrong}, launches {launches}")
    return files, launches


def media_search(emb, col, blocks, caps, rows, rng):
    """MEDIA_QUERIES stored images with pixel noise as image queries and
    MEDIA_QUERIES captions as text queries (the default dense fusion, then
    rrf) through `hybrid_search_batch`;
    every scan and match launch held to plain; top-10 rows and scores
    against a CPU copy of the collection (saved and loaded). Returns
    (launches by kernel entry, (int8 scan, bf16 scan, bm25) max abs
    errors)."""
    import shutil

    import torch

    from rag_application_tpu_torch.config import Config
    from rag_application_tpu_torch.index.checkpoint import (load_collection,
                                                             save_collection)
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.search.params import adaptive_funnel

    qi = rng.choice(MEDIA_IMAGES, MEDIA_QUERIES, replace=False)
    noisy = media_raster(blocks[qi])
    noisy += rng.uniform(-MEDIA_NOISE, MEDIA_NOISE,
                         noisy.shape).astype(np.float32)
    np.clip(noisy, 0.0, 1.0, out=noisy)
    q_img = emb.encode_image(noisy)
    qt = rng.choice(MEDIA_IMAGES, MEDIA_QUERIES, replace=False)
    texts = [caps[i] for i in qt]
    q_txt = emb.encode(texts)
    col.hybrid_search_batch(q_txt[:1], texts[:1], K)  # the sparse rebuild
    torch.cuda.synchronize()
    rrf = dataclasses.replace(adaptive_funnel(col.dense.size, col.cfg.funnel),
                              final_fusion="rrf")
    with recording(ft, "scan_sheet", ft.route_launches) as scans, \
            recording(ob, "bm25_match_rows") as matches:
        reset_scan_counts(ft)
        ob.bm25_match_rows.launches = 0
        t0 = time.perf_counter()
        hi = col.hybrid_search_batch(q_img, None, K)
        t1 = time.perf_counter()
        ht = col.hybrid_search_batch(q_txt, texts, K)
        t2 = time.perf_counter()
        hr = col.hybrid_search_batch(q_txt, texts, K, funnel=rrf)
        launches = {**scan_counts(ft),
                    "bm25_match": ob.bm25_match_rows.launches}
    errs = check_recorded("[media] searches", scans, matches)
    if ft.route_launches["fused_scan"] or not all(launches.values()):
        raise AssertionError(f"[media] launches {launches}")
    own = np.mean([bool(h) and h[0].row == rows[i] for h, i in zip(hi, qi)])
    own10 = np.mean([rows[i] in [x.row for x in h] for h, i in zip(hi, qi)])
    cap10 = np.mean([rows[i] in [x.row for x in h] for h, i in zip(ht, qt)])
    rrf10 = np.mean([rows[i] in [x.row for x in h] for h, i in zip(hr, qt)])
    log(f"  {MEDIA_QUERIES} image queries (stored images, pixel noise "
        f"+-{MEDIA_NOISE:.4f}, no caption) in {(t1 - t0) * 1e3:.1f} ms: own "
        f"image first {own:.1%}, in the top 10 {own10:.1%}; {MEDIA_QUERIES} "
        f"caption queries (dense + BM25) in {(t2 - t1) * 1e3:.1f} ms: own "
        f"image in the top 10 {cap10:.1%} (the default dense fusion orders "
        f"the candidates by the text vector's cosine to image vectors), "
        f"{rrf10:.1%} with rrf fusion; launches {launches}")

    # the CPU copy runs the card's engine ("pallas": the scan kernels'
    # plain versions, which bin candidates as the kernels do); "auto"
    # would pick the blocked approximate top-k there, other candidates
    path = "build/smoke_media/collection"
    shutil.rmtree(path, ignore_errors=True)
    save_collection(col, path)
    cfg = Config()
    cfg.funnel = dataclasses.replace(cfg.funnel, scan_impl="pallas")
    cpu = load_collection(path, cfg, device="cpu")
    shutil.rmtree("build/smoke_media", ignore_errors=True)
    tol = 2 * DIM * 2.0 ** -24
    bad, n = 0, 0
    for hits, q, tx, f in ((hi, q_img, None, None), (ht, q_txt, texts, None),
                           (hr, q_txt, texts, rrf)):
        want = cpu.hybrid_search_batch(q, tx, K, funnel=f)
        for a, b in zip(hits, want):
            n += 1
            bad += not rescored_agree([h.row for h in a], [h.score for h in a],
                                      [h.row for h in b], [h.score for h in b],
                                      tol)
    log(f"  top-10 rows and scores against a CPU copy of the collection "
        f"(save_collection, load_collection on the CPU, the card's scan "
        f"engine): {n - bad} of {n} "
        f"queries agree (scores within {tol:.3g}, other rows only at "
        f"near-ties)")
    if bad:
        raise AssertionError(f"[media] {bad} queries differ from the CPU copy")
    return launches, errs


def media_embeddings(emb, files, dev):
    """`/v1/embeddings` with data-URL PNG and JPEG blocks on
    `build_app(embedder=emb)`: each vector equal to a direct
    `encode_image` call with its caption."""
    import base64

    from rag_application_tpu_torch.api.app import build_app
    from rag_application_tpu_torch.config import Config
    from rag_application_tpu_torch.llm.router import LLMRouter, Provider
    from rag_application_tpu_torch.models.image import image_to_input

    png = next(d for k, _, d, _ in files if k == "png")
    jpeg = next(d for k, _, d, _ in files if k == "jpeg")
    items = [("a scanned page", png, "image/png"),
             ("a photo", jpeg, "image/jpeg"),
             ("", png, "image/png")]
    body = {"input": [
        [{"type": "text", "text": c}] * bool(c) + [
            {"type": "image_url", "image_url": {
                "url": f"data:{m};base64," + base64.b64encode(d).decode()}}]
        for c, d, m in items] + ["a plain text row"]}
    router, _ = build_app(Config(), llm=LLMRouter(Provider.STUB),
                          embedder=emb, device=dev)
    srv = ServerThread(router)
    port = srv.start()
    try:
        status, out, ms = http_call(port, "POST", "/v1/embeddings", body)
    finally:
        srv.stop()
    if status != 200:
        raise AssertionError(f"[media] /v1/embeddings {status}: {out}")
    got = np.asarray([d["embedding"] for d in out["data"]], np.float32)
    size = emb.state.model.image_size
    want = emb.encode_image(np.stack([image_to_input(d, size)
                                      for _, d, _ in items]),
                            texts=[c for c, _, _ in items])
    text = emb.encode(["a plain text row"])
    err = max(float(np.abs(got[:3] - want).max()),
              float(np.abs(got[3:] - text).max()))
    log(f"  /v1/embeddings: {len(items)} image blocks (PNG and JPEG data "
        f"URLs, two with captions) and a text row in {ms:.1f} ms; max abs "
        f"diff to encode_image / encode {err:.3g}")
    if err > 1e-6:
        raise AssertionError(f"[media] /v1/embeddings differs by {err}")


def run_media(dev):
    """[media]: the multimodal tower at EncoderConfig() widths. Returns
    (scan and match launches by kernel entry, (int8 scan, bf16 scan,
    bm25) max abs errors, prep launches)."""
    import torch

    from rag_application_tpu_torch.config import Config, EncoderConfig
    from rag_application_tpu_torch.config import KGConfig
    from rag_application_tpu_torch.kg.store import KGStore
    from rag_application_tpu_torch.models.embedder import Embedder
    from rag_application_tpu_torch.models.encoder import init_encoder
    from rag_application_tpu_torch.store.collection import Collection

    t0 = time.perf_counter()
    state = init_encoder(EncoderConfig(), seed=0, multimodal=True, device=dev)
    emb = Embedder(state, max_len=EMB_LEN, batch_size=EMB_BATCH)
    nparams = sum(t.numel() for t in state.params.values())
    log(f"  set-up {time.perf_counter() - t0:.1f} s: MultimodalEncoder "
        f"{nparams / 1e6:.2f}M params (random, seed 0) on {emb.device}, "
        f"Embedder(max_len={EMB_LEN}, batch_size={EMB_BATCH})")
    log(f"[media-check] the card's tower against a CPU copy (cosine >= "
        f"{MEDIA_COS})")
    check_err = check_media_tower(emb)
    rng = np.random.default_rng(47)
    col = Collection("user_media", Config(), device=dev)
    kg = KGStore(KGConfig(), dim=min(emb.dim, 2048), device=dev)
    log(f"[media] direct encodes: {MEDIA_IMAGES:,} images and "
        f"{MEDIA_CLIPS:,} clips, stored as albums of {MEDIA_BATCH}")
    blocks, caps, rows, direct_preps = media_direct(emb, col, rng)
    log("[media] IngestPipeline: PNG, JPEG, WAV, FLAC and MJPEG files into "
        "the collection and a KGStore")
    files, pipe_preps = media_pipeline(emb, col, kg, rng, dev)
    log(f"[media] hybrid search over {col.dense.size:,} chunks")
    launches, errs = media_search(emb, col, blocks, caps, rows, rng)
    media_embeddings(emb, files, dev)
    log(f"  [media-check] max abs err {check_err:.3g}")
    del col, kg, emb, state
    torch.cuda.empty_cache()
    return launches, errs, direct_preps + pipe_preps


def media_phase(dev, card):
    """[media], logged with its time; returns `run_media`'s."""
    t0 = time.perf_counter()
    log(f"[media] MultimodalEncoder at EncoderConfig() widths: direct "
        f"encodes, IngestPipeline on media files, search, /v1/embeddings "
        f"({card})")
    out = run_media(dev)
    log(f"[media] {time.perf_counter() - t0:.1f} s")
    return out


def media_only(dev, card) -> int:
    """`--media`: [media] alone."""
    media_phase(dev, card)
    log(card)
    return 0


def serve_phase(emb, dev, gen, ckpt, card):
    """[serve], logged with its time; returns `run_serve`'s. Builds the
    [gen-main] weights when ``gen`` is None."""
    import torch

    from rag_application_tpu_torch.models import decoder as dec

    t0 = time.perf_counter()
    if gen is None:
        cfg = dec.DecoderConfig(**GEN_CFG)
        g = torch.Generator(device=dev).manual_seed(0)
        gen = (dec.quantize_decoder_params(
            dec.init_decoder_params(g, cfg, dev)), cfg)
    log(f"[serve] build_app + restore_spaces ({ckpt[1]}, saved in "
        f"{ckpt[3]:.2f} s, {ckpt[4]:,.1f} MB), HTTPServer, every route by the "
        f"standard library's client, LOCAL generation at TinyLlama-1.1B "
        f"widths, then the server as its own process ({card})")
    import os
    import shutil

    try:
        out = run_serve(emb, dev, gen, ckpt)
    finally:
        shutil.rmtree(os.path.dirname(ckpt[0]), ignore_errors=True)
    log(f"[serve] {time.perf_counter() - t0:.1f} s")
    return out


def ann_phase(col, emb, tokens, dev, card):
    """[ann], logged with its time; returns `run_ann`'s."""
    t0 = time.perf_counter()
    log(f"[ann] IVFIndex at the repo's ANN configuration ({ANN_N:,} x {DIM}, "
        f"C {ANN_CLUSTERS}), then Collection.build_ann/ann_search over the "
        f"[ingest] collection ({card})")
    out = run_ann(col, emb, tokens, dev)
    log(f"[ann] {time.perf_counter() - t0:.1f} s")
    return out


def agents_phase(col, emb, kg, tokens, dev, card):
    """[agents], logged with its time; returns `run_agents`'s."""
    t0 = time.perf_counter()
    log(f"[agents] the knowledge toolbox, {AGENT_TURNS} KnowledgeSearchAgent "
        f"turns and a DeepResearchAgent run over the collection and the KG "
        f"({card})")
    out = run_agents(col, emb, kg, tokens, dev)
    log(f"[agents] {time.perf_counter() - t0:.1f} s")
    return out


def run_read_path(col, emb, ing_tokens, ing_texts, dev, card):
    """[kg], [orch], [batcher], [hybrid] and [checkpoint] over the
    [ingest] collection. Returns ((int8 scan, bf16 scan, bm25) max abs
    errors of the recorded launches, the prep kernel's at the KG shape,
    the KGStore)."""
    t0 = time.perf_counter()
    log(f"[kg] KGStore at the API's width, one page of {KG_ENTS} entities "
        f"and {KG_RELS} relationships a document, then deduplicate ({card})")
    kg, names, page_names, prep_err_kg = run_kg(col, emb, ing_texts, dev)
    log(f"[kg] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"[orch] SearchOrchestrator.execute, {ORCH_QUERIES} queries, STUB "
        f"router ({card})")
    queries = orch_queries(ing_tokens, page_names)
    orch_results, orch_errs = run_orch(col, emb, kg, names, queries)
    log(f"[orch] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"[batcher] MicroBatcher over the tokens wire, {BATCHER_REQS} "
        f"concurrent requests ({card})")
    errs = list(map(max, zip(orch_errs,
                             run_batcher(col, emb, ing_tokens))))
    log(f"[batcher] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"[hybrid] HybridSearcher.search, {HYB_QUERIES} queries ({card})")
    errs[2] = max(errs[2], run_hybrid(col, emb, ing_tokens))
    log(f"[hybrid] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"[checkpoint] save and load the collection and the KG ({card})")
    tok_texts = noisy_texts(ing_tokens,
                            np.arange(TOK_BATCH) * 97 % len(ing_tokens), 950)
    errs = list(map(max, zip(errs, run_checkpoint(
        col, kg, emb, names, queries, orch_results, tok_texts, dev))))
    log(f"[checkpoint] {time.perf_counter() - t0:.1f} s")
    return tuple(errs), prep_err_kg, kg


def pipeline_phase(col, emb, kg, ing_rate, dev, card):
    """[pipeline], logged with its time; returns `run_pipeline`'s."""
    t0 = time.perf_counter()
    log(f"[pipeline] IngestPipeline into the collection and the KG: the real"
        f" fixtures, {PIPE_DOCS} generated text documents, a built PDF and "
        f"docx, one URL ({card})")
    out = run_pipeline(col, emb, kg, ing_rate, dev)
    log(f"[pipeline] {time.perf_counter() - t0:.1f} s")
    return out


def read_path_only(dev, card) -> int:
    """`--read-path`: [ingest], [tokens], the read-path phases and
    [pipeline] alone."""
    col, emb, ing_tokens, ing_texts, _, ing_rate = run_ingest(dev)
    run_tokens(col, emb, ing_tokens)
    _, _, kg = run_read_path(col, emb, ing_tokens, ing_texts, dev, card)
    pipeline_phase(col, emb, kg, ing_rate, dev, card)
    log(card)
    return 0


def pipeline_only(dev, card) -> int:
    """`--pipeline`: [ingest], then [pipeline] into its collection and a
    new KGStore at the API's width."""
    from rag_application_tpu_torch.config import KGConfig
    from rag_application_tpu_torch.kg.store import KGStore

    col, emb, _, _, _, ing_rate = run_ingest(dev)
    kg = KGStore(KGConfig(), dim=min(emb.dim, 2048), device=dev)
    pipeline_phase(col, emb, kg, ing_rate, dev, card)
    log(card)
    return 0


def ann_only(dev, card) -> int:
    """`--ann`: [ingest], then [ann] over its collection."""
    col, emb, ing_tokens, _, _, _ = run_ingest(dev)
    ann_phase(col, emb, ing_tokens, dev, card)
    log(card)
    return 0


def agents_only(dev, card) -> int:
    """`--agents`: [ingest] and [kg], then [agents] over their stores."""
    col, emb, ing_tokens, ing_texts, _, _ = run_ingest(dev)
    t0 = time.perf_counter()
    log(f"[kg] KGStore at the API's width ({card})")
    kg, *_ = run_kg(col, emb, ing_texts, dev)
    log(f"[kg] {time.perf_counter() - t0:.1f} s")
    agents_phase(col, emb, kg, ing_tokens, dev, card)
    log(card)
    return 0


def serve_only(dev, card) -> int:
    """`--serve`: [ingest] and [kg], saved as one user space, then [serve]
    (with the [gen-main] weights built here)."""
    import torch

    col, emb, _, ing_texts, _, _ = run_ingest(dev)
    t0 = time.perf_counter()
    log(f"[kg] KGStore at the API's width ({card})")
    kg, *_ = run_kg(col, emb, ing_texts, dev)
    log(f"[kg] {time.perf_counter() - t0:.1f} s")
    ckpt = serve_checkpoint(col, kg, emb, dev)
    del col, kg
    torch.cuda.empty_cache()
    serve_phase(emb, dev, None, ckpt, card)
    log(card)
    return 0


def attn_only(dev, card) -> int:
    """`--attn`: the decode-attention kernel's checks and times alone, for
    kernel work on it (no tables, search, write path or generation)."""
    log("[gen-check] decode_attn kernel vs plain on the card")
    err, args, batch = check_decode_attn(dev)
    log(f"[gen-check] every case held; max abs err {err:.3g}")
    log(f"[gen-time] decode_attn at the main decode shape, [batch]'s and "
        f"the chat's ({card})")
    time_decode_attn(dev, args, batch)
    log(card)
    return 0


def batch_phase(params, cfg, dev, card):
    """[batch], logged with its time; returns `run_batch`'s."""
    t0 = time.perf_counter()
    log(f"[batch] LocalLLM.enable_batching(slots={BATCH_SLOTS}, prompt_pad="
        f"{BATCH_PROMPT}, horizon={BATCH_HORIZON}, chunk={BATCH_CHUNK}, "
        f"lookahead={BATCH_LOOKAHEAD}), {BATCH_REQS} chats x {BATCH_NEW} new "
        f"sharing a {BATCH_HEADER}-token prefix, TinyLlama-1.1B widths, int8 "
        f"weights + int8 KV, attn_kernel ({card})")
    out = run_batch(params, cfg, dev)
    log(f"[batch] {time.perf_counter() - t0:.1f} s")
    return out


def batch_only(dev, card) -> int:
    """`--batch`: the decode-attention kernel's checks and times, then
    [batch] alone (with the [gen-main] weights built here)."""
    import torch

    from rag_application_tpu_torch.models import decoder as dec

    attn_only(dev, card)
    torch.cuda.empty_cache()
    cfg = dec.DecoderConfig(**GEN_CFG)
    g = torch.Generator(device=dev).manual_seed(0)
    params = dec.quantize_decoder_params(dec.init_decoder_params(g, cfg, dev))
    batch_phase(params, cfg, dev, card)
    log(card)
    return 0


def train_only(dev, card) -> int:
    """`--train`: [train] alone (with the [gen-main] weights built
    here)."""
    import torch

    from rag_application_tpu_torch.models import decoder as dec

    cfg = dec.DecoderConfig(**GEN_CFG)
    g = torch.Generator(device=dev).manual_seed(0)
    params = dec.quantize_decoder_params(dec.init_decoder_params(g, cfg, dev))
    train_phase(params, cfg, dev, card)
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
    log(f"[prep-time] prepare_vectors at the slab, document and one-row "
        f"shapes ({card})")
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


def cpu_embedder_factory():
    """A stand-in for `models.embedder.Embedder` that builds the default
    encoder on the CPU: `init_encoder` draws from a CPU generator, so the
    weights are the card's; an Embedder given a state keeps its device."""
    from rag_application_tpu_torch.models import embedder as memb
    from rag_application_tpu_torch.models.encoder import init_encoder

    real = memb.Embedder

    def factory(state=None, *, cfg=None, **kw):
        if state is None:
            state = init_encoder(cfg, device="cpu")
        return real(state, cfg=cfg, **kw)

    return factory


def eval_files():
    """The fixtures the stack ingests here: all six, or the five that
    need no pandas where it is missing."""
    import importlib.util

    from rag_application_tpu_torch.evals.real_docs import FIXTURES

    if importlib.util.find_spec("pandas") is not None:
        return list(FIXTURES)
    return [f for f in FIXTURES if not f.endswith(".csv")]


@contextlib.contextmanager
def first_document_held(label):
    """While the block runs, the prep, scan and match launches of the
    first `IngestPipeline.ingest_file` call are recorded and held to
    plain as soon as that call returns (before a later write can change
    the planes). Yields a dict that then holds the prep launches by
    (rows, dims) and the scan and match counts."""
    from rag_application_tpu_torch.index import dense as idense
    from rag_application_tpu_torch.ingest.pipeline import IngestPipeline
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft

    orig = IngestPipeline.ingest_file
    held = {}

    async def first(self, *args, **kwargs):
        if held:
            return await orig(self, *args, **kwargs)
        with recording(idense, "prepare_vectors_into") as preps, \
                recording(ft, "scan_sheet", ft.route_launches) as scans, \
                recording(ob, "bm25_match_rows") as matches:
            out = await orig(self, *args, **kwargs)
        held["preps"] = check_preps(f"{label}, {args[0]}", preps)
        if scans:
            check_recorded(f"{label}, {args[0]}", routed(scans), matches)
        elif matches:
            check_matches(f"{label}, {args[0]}", matches)
        held["scans"], held["matches"] = len(scans), len(matches)
        return out

    with mock.patch.object(IngestPipeline, "ingest_file", first):
        yield held


@contextlib.contextmanager
def eval_log():
    """The evals' gate messages (logger ``rag_application_tpu_torch.evals``,
    INFO and up) while the block runs."""
    import logging

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("rag_application_tpu_torch.evals")
    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def hybrid_texts(stack, query, limit):
    """(text, score) of a stack's hybrid hits for one question."""
    qv = stack.embedder.encode([query])[0]
    return [(str(h.payload.get("text", "")), float(h.score))
            for h in stack.collection.hybrid_search(qv, query, limit=limit)]


def flags_held(card, cpu, res_card, res_cpu):
    """The card's per-question flags against the CPU copy's: equal, or
    different only where the two top-EVAL_K hybrid rankings differ at a
    near-tie (EVAL_TIE). Returns the questions that differ at one."""
    ties = []
    for a, b in zip(res_card["per_question"], res_cpu["per_question"]):
        if (a["retrieved"], a["answered"]) == (b["retrieved"],
                                               b["answered"]):
            continue
        q = a["query"]
        hc = hybrid_texts(card, q, 2 * EVAL_K)
        hp = hybrid_texts(cpu, q, 2 * EVAL_K)
        first = next((i for i in range(EVAL_K)
                      if i >= len(hc) or i >= len(hp)
                      or hc[i][0] != hp[i][0]), None)
        card_texts = [t for t, _ in hc]
        near = (first is not None and first < len(hc) and first < len(hp)
                and hp[first][0] in card_texts
                and abs(hc[first][1] - hc[card_texts.index(
                    hp[first][0])][1]) <= EVAL_TIE)
        log(f"  flags differ on {q!r}: card {a['retrieved']}/"
            f"{a['answered']}, CPU {b['retrieved']}/{b['answered']}; "
            f"rankings first differ at rank {first}: card {hc[:EVAL_K]}, "
            f"CPU {hp[:EVAL_K]}")
        if not near:
            raise AssertionError(f"[evals] flags differ from the CPU copy "
                                 f"on {q!r} away from a near-tie")
        ties.append(q)
    return ties


def eval_summary(label, res, seconds):
    log(f"  {label}: {res['n_questions']} questions in {seconds:.1f} s, "
        f"retrieval_recall_at_{res['k']} {res['retrieval_recall_at_k']:.4f}"
        f", answer_hit_rate {res['answer_hit_rate']:.4f}; missed: "
        f"{[q['query'][:40] for q in res['per_question'] if not q['retrieved']]}")


def run_real_docs(dev):
    """[evals], real documents: `build_real_docs_stack` on the card over
    `eval_files()` at Config() widths (the first document's launches
    held to plain as it is ingested), `evaluate_real_docs` on every
    question (the first question's launches held to plain), the same
    through a CPU copy with the card's weights (flags held), then the
    stack again with EVAL_TRAIN_STEPS of fine-tuning and its gates.
    Returns (scan and match launches by kernel entry, (int8 scan, bf16
    scan, bm25) max abs errors, prep launches)."""
    import asyncio

    import torch

    from rag_application_tpu_torch.config import Config
    from rag_application_tpu_torch.evals import real_docs as rd
    from rag_application_tpu_torch.models import embedder as memb
    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import fused_topk as ft
    from rag_application_tpu_torch.ops import quant as oq

    files = eval_files()
    log(f"  fixtures {files}; {len(rd.QUESTIONS)} questions, k {EVAL_K}")
    reset_scan_counts(ft)
    ob.bm25_match_rows.launches = 0
    oq.prepare_vectors_into.launches = 0

    t0 = time.perf_counter()
    with first_document_held("[evals] first document") as held:
        card = asyncio.run(rd.build_real_docs_stack(files=files))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    failed = {n: r.failed_tasks for n, r in card.ingest_results.items()
              if r.failed_tasks}
    log(f"  stack on {card.embedder.device}: {len(card.chunk_texts)} chunks, "
        f"KG {card.kg.stats()}, ingest {ingest_s:.2f} s (Embedder set-up "
        f"included); first document's launches held: {held}; failed "
        f"tasks {failed}")
    if failed or not card.chunk_texts:
        raise AssertionError(f"[evals] ingest failed: {failed}")

    with recording(ft, "scan_sheet", ft.route_launches) as scans, \
            recording(ob, "bm25_match_rows") as matches:
        asyncio.run(rd.evaluate_real_docs(card, k=EVAL_K,
                                          questions=rd.QUESTIONS[:1]))
    errs = check_recorded("[evals] first question", routed(scans), matches)
    t0 = time.perf_counter()
    res = asyncio.run(rd.evaluate_real_docs(card, k=EVAL_K))
    eval_summary("untrained, card", res, time.perf_counter() - t0)

    # the CPU copy: the card's weights, the card's scan engine
    cfg = Config()
    cfg.funnel.final_fusion = "dbsf"
    cfg.funnel.scan_impl = "pallas"
    t0 = time.perf_counter()
    with mock.patch.object(memb, "Embedder", cpu_embedder_factory()):
        cpu = asyncio.run(rd.build_real_docs_stack(files=files, config=cfg))
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_res = asyncio.run(rd.evaluate_real_docs(cpu, k=EVAL_K))
    eval_summary(f"untrained, CPU copy (built in {built:.1f} s)", cpu_res,
                 time.perf_counter() - t0)
    if sorted(cpu.chunk_texts) != sorted(card.chunk_texts):
        raise AssertionError("[evals] the CPU copy's chunks differ")
    ties = flags_held(card, cpu, res, cpu_res)
    log(f"  per-question flags equal to the CPU copy's but at "
        f"{len(ties)} near-ties")
    del cpu
    launches = {**scan_counts(ft), "bm25_match": ob.bm25_match_rows.launches}

    t0 = time.perf_counter()
    with eval_log() as gates:
        trained = asyncio.run(rd.build_real_docs_stack(
            files=files, train_steps=EVAL_TRAIN_STEPS))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tres = asyncio.run(rd.evaluate_real_docs(trained, k=EVAL_K))
    log(f"  train_steps {EVAL_TRAIN_STEPS}: stack built in {train_s:.1f} s; "
        f"gates: {gates or ['none fired: the trained stack shipped']}")
    eval_summary(f"train_steps {EVAL_TRAIN_STEPS}, card", tres,
                 time.perf_counter() - t0)
    launches = {**scan_counts(ft), "bm25_match": ob.bm25_match_rows.launches}
    preps = oq.prepare_vectors_into.launches
    log(f"  launches {launches}, prep_vectors {preps}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[evals] kernel {name} never launched")
    del card, trained
    torch.cuda.empty_cache()
    return launches, errs, preps


def run_multimodal_eval(dev):
    """[evals], multimodal: the first MM_CHECK_STEPS losses of
    `train_multimodal` on the card against a CPU copy (2-step runs from
    the same weights on the same batches), then `evaluate_multimodal`
    at its defaults on the card, held to the reference test's floors."""
    import torch

    from rag_application_tpu_torch.evals import multimodal as mm

    scenes = mm.all_scenes()
    order = np.random.default_rng(0).permutation(len(scenes))
    train = [scenes[i] for i in order[:int(len(scenes) * 0.75)]]
    card_l = mm.train_multimodal(mm.default_embedder(dev), train,
                                 steps=MM_CHECK_STEPS)
    cpu_l = mm.train_multimodal(mm.default_embedder("cpu"), train,
                                steps=MM_CHECK_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    log(f"  first {MM_CHECK_STEPS} steps: card losses {card_l}, CPU copy "
        f"{cpu_l}, worst relative error {rel:.3g} (<= {MM_LOSS_RTOL})")
    if rel > MM_LOSS_RTOL:
        raise AssertionError(f"[evals] multimodal losses: {card_l} vs "
                             f"{cpu_l}")

    losses = []
    real = mm.train_multimodal

    def kept(*args, **kwargs):
        losses.extend(real(*args, **kwargs))
        return losses

    t0 = time.perf_counter()
    with mock.patch.object(mm, "train_multimodal", kept):
        res = mm.evaluate_multimodal(steps=MM_STEPS, k=MM_KS,
                                     embedder=mm.default_embedder(dev))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    recalls = {k: round(v, 4) for k, v in res.items() if "recall" in k}
    log(f"  evaluate_multimodal(steps={MM_STEPS}) in {secs:.1f} s: loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; {int(res['n_test'])} held-out "
        f"scenes; recalls {recalls}; chance@5 {res['chance_at_5']:.4f}")
    c5 = res["chance_at_5"]
    floors = {"text_to_image_recall_at_5": 4 * c5,
              "text_to_audio_recall_at_5": 4 * c5,
              "image_to_audio_recall_at_5": 2 * c5}
    for key, floor in floors.items():
        if res[key] < floor:
            raise AssertionError(f"[evals] {key} {res[key]:.4f} < {floor:.4f}")
    return res


def evals_phase(dev, card):
    """[evals], logged with its time; returns `run_real_docs`'s."""
    t0 = time.perf_counter()
    log(f"[evals] evals/real_docs.py at Config() widths (untrained and "
        f"train_steps {EVAL_TRAIN_STEPS}), then evals/multimodal.py at its "
        f"defaults ({card})")
    out = run_real_docs(dev)
    log("[evals] multimodal: evaluate_multimodal on the card")
    run_multimodal_eval(dev)
    log(f"[evals] {time.perf_counter() - t0:.1f} s")
    return out


def evals_only(dev, card) -> int:
    """`--evals`: [evals] alone."""
    evals_phase(dev, card)
    log(card)
    return 0


def shard_spec(dense, sparse, rps):
    """The main path's funnel as a spec (`FusedSpec.from_funnel`) with the
    cascade and the sparse branch, as `sharded_fused_hybrid` runs it on
    each shard (the plain scan, dense final ranking); the same spec runs
    the one-device reference."""
    from rag_application_tpu_torch.config import FunnelConfig
    from rag_application_tpu_torch.search.fused import FusedSpec

    funnel = FunnelConfig(matryoshka_limits=(512, 256), dense_limit=24,
                          quantized_limit=32, sparse_limit=12,
                          final_limit=K)
    spec = FusedSpec.from_funnel(
        funnel, dense.cfg.matryoshka_dims, k=K,
        block_size=dense.cfg.block_size, use_sparse=True,
        use_matryoshka=True, has_filter=False,
        sparse_pool=sparse.cfg.candidate_pool,
        recall_target=dense.cfg.approx_recall_target)
    one = spec._replace(block_size=min(spec.block_size, rps),
                        scan_impl="xla", scan_prefix_dim=0,
                        final_fusion="dense")
    return spec, one


def sharded_vs_one(s_vals, s_ids, o_vals, o_ids, vecs, q):
    """The sharded funnel's rows against the one-device funnel's: equal
    ids with scores within SHARD_ATOL, or a row list at least as good —
    each shard keeps its own limits, so the sharded candidate lists are
    wider, and where the one-device funnel missed a true neighbour the
    sharded one can find it: then every id the one-device list has and
    the sharded one lacks must score no more than the sharded list's
    last, and no score may fall. In such a row the ids must be distinct
    and each score the exact dense score of its id (the unit query's dot
    with its bf16 row, here in f64) within SHARD_ATOL; at most
    SHARD_UNEQUAL of the rows may differ. Returns (rows equal, rows
    better)."""
    import torch

    sv, si = s_vals.cpu().numpy(), s_ids.cpu().numpy()
    ov, oi = o_vals.cpu().numpy(), o_ids.cpu().numpy()
    diff = [r for r in range(si.shape[0]) if not (si[r] == oi[r]).all()]
    same = np.setdiff1d(np.arange(si.shape[0]), diff)
    if np.abs(sv[same] - ov[same]).max(initial=0) > SHARD_ATOL:
        raise AssertionError(f"[shard] rows with equal ids, scores differ "
                             f"by {np.abs(sv[same] - ov[same]).max()}")
    if len(diff) > SHARD_UNEQUAL * si.shape[0]:
        raise AssertionError(f"[shard] {len(diff)} of {si.shape[0]} rows "
                             f"differ from one device's (cap "
                             f"{SHARD_UNEQUAL:.0%})")
    if not diff:
        return si.shape[0], 0
    rows = torch.tensor(diff, device=q.device)
    ids = s_ids[rows].long()
    if (ids < 0).any() or (ids >= vecs.shape[0]).any():
        raise AssertionError(f"[shard] invalid ids in rows {diff}")
    qd = q[rows].double()
    qd = qd / torch.linalg.vector_norm(qd, dim=-1, keepdim=True)
    true = torch.einsum("qd,qkd->qk", qd, vecs[ids].double()).cpu().numpy()
    for n, r in enumerate(diff):
        lost = [j for j in range(oi.shape[1]) if oi[r, j] not in si[r]]
        if len(set(si[r])) != si.shape[1] \
                or np.abs(sv[r] - true[n]).max() > SHARD_ATOL \
                or any(ov[r, j] > sv[r, -1] + SHARD_ATOL for j in lost) \
                or (sv[r] < ov[r] - SHARD_ATOL).any():
            raise AssertionError(f"[shard] row {r}: sharded {si[r]} "
                                 f"{sv[r]} (exact {true[n]}) against one "
                                 f"device's {oi[r]} {ov[r]}")
    return si.shape[0] - len(diff), len(diff)


def run_shard_funnel(mesh, dense, sparse, tokens, rng):
    """[shard], the funnel: slice A's tables cut over the mesh, then
    `sharded_fused_hybrid` with the main path's spec on SHARD_BATCHES + 1
    batches of SHARD_BATCH noisy rows, against one `fused_core` call on
    the whole tables with the same spec. Returns the bm25 match
    launches (counted around the sharded calls only) and their max abs
    error."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.parallel import mesh as pm
    from rag_application_tpu_torch.parallel import search as ps
    from rag_application_tpu_torch.parallel.sparse import \
        build_sharded_sparse
    from rag_application_tpu_torch.search.fused import fused_core

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    vecs = ps.shard_corpus(mesh, dense.vecs[:N])
    int8 = ps.shard_corpus(mesh, dense.int8[:N])
    inv = pm.shard_rows(mesh, dense.inv_norms[:N])
    live = pm.shard_rows(mesh, dense.live[:N])
    sh = build_sharded_sparse(sparse, SHARDS)
    t_host = time.perf_counter() - t0
    post = pm.shard_stacked(mesh, sh["post_packed"])
    docp = pm.shard_stacked(mesh, sh["doc_packed"])
    torch.cuda.synchronize()
    rps = sh["rows_per_shard"]
    log(f"  cut over {mesh}: {rps:,} rows a shard (the dense planes as "
        f"views), build_sharded_sparse {t_host:.1f} s on the host (V_pad "
        f"{sh['v_pad']}, P {sh['p']}, L {sh['l']}); "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB of new "
        f"sparse tables")
    spec, one = shard_spec(dense, sparse, rps)
    dv = sparse.device_arrays()

    torch.cuda.reset_peak_memory_stats()
    times, equal, better, err, launched = [], 0, 0, 0.0, 0
    for b in range(SHARD_BATCHES + 1):
        q, texts = make_queries(dense, tokens, rng, 300 + b)
        q, texts = q[:SHARD_BATCH], texts[:SHARD_BATCH]
        sq = sparse.encode_queries(texts)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ob.bm25_match_rows.launches = 0
        with recording(ob, "bm25_match_rows") as matches:
            ev0.record()
            s_vals, s_ids = ps.sharded_fused_hybrid(
                mesh, vecs, int8, inv, live, post, docp, q, *sq, K,
                spec=spec, valid_n=N)
            ev1.record()
            torch.cuda.synchronize()
        n_match = ob.bm25_match_rows.launches
        launched += n_match
        if n_match != SHARDS or len(matches) != SHARDS:
            raise AssertionError(f"[shard] {n_match} bm25 match launches "
                                 f"in a batch, {len(matches)} recorded")
        err = max(err, check_matches(f"[shard] batch {b}", matches))
        times.append(ev0.elapsed_time(ev1))
        o_vals, o_ids = fused_core(
            dense.vecs, dense.int8, dense.inv_norms, dense.live, N, q, None,
            (dv["post_docs"], dv["post_weights"], dv["doc_packed"]), sq, one)
        e, bt = sharded_vs_one(s_vals, s_ids, o_vals, o_ids, dense.vecs, q)
        equal, better = equal + e, better + bt
        exact = exact_top_ids(dense, q[:N_EVAL], K)
        rec = [float(np.mean([np.isin(exact[i], ids[i]).mean()
                              for i in range(N_EVAL)]))
               for ids in (s_ids[:N_EVAL].cpu().numpy(),
                           o_ids[:N_EVAL].cpu().numpy())]
        log(f"  batch {b}: {times[-1]:.2f} ms (CUDA events, {SHARDS} shards "
            f"issued in turn); rows equal to one fused_core call {e} of "
            f"{SHARD_BATCH}, at least as good (their scores exact) {bt}; "
            f"recall@10 vs exact on {N_EVAL}: sharded {rec[0]:.4f}, one device {rec[1]:.4f}")
        if rec[0] < 0.95:
            raise AssertionError(f"[shard] recall@10 {rec[0]:.4f} < 0.95")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ms = times[1:]
    log(f"  sharded_fused_hybrid: {np.mean(ms):.2f} ms a batch of "
        f"{SHARD_BATCH} (batches after the first: {[round(t, 2) for t in ms]})"
        f"; rows equal {equal}, at least as good {better}; bm25 match "
        f"launches {SHARDS} a batch, each bit-equal to plain; peak device "
        f"memory above the tables {peak:.2f} GiB")
    one_ms = cuda_ms(lambda: fused_core(
        dense.vecs, dense.int8, dense.inv_norms, dense.live, N, q, None,
        (dv["post_docs"], dv["post_weights"], dv["doc_packed"]), sq, one),
        reps=1, warmup=0)
    log(f"  one fused_core call on the whole tables, same spec: "
        f"{one_ms:.2f} ms a batch")
    del vecs, int8, inv, live, post, docp, sh
    return launched, err


def shard_hits_equal(got, want, label):
    """Sharded KG hits against the one-device store's: the same (space,
    row) list with scores within SHARD_ATOL, but where two hits' scores
    lie within SHARD_ATOL of each other (a near-tie may swap them)."""
    ka = [(h["space"], h["row"]) for h in got]
    kb = [(h["space"], h["row"]) for h in want]
    sa = np.array([h["score"] for h in got])
    sb = np.array([h["score"] for h in want])
    if len(ka) != len(kb) or np.abs(sa - sb).max(initial=0) > SHARD_ATOL:
        raise AssertionError(f"{label}: {got} vs {want}")
    for i in range(len(ka)):
        if ka[i] != kb[i] and not any(
                kb[j] == ka[i] and abs(sb[j] - sb[i]) <= SHARD_ATOL
                for j in range(len(kb))):
            raise AssertionError(f"{label}: hit {i} {ka[i]} vs {kb[i]}")
    return ka != kb


def run_shard_kg(mesh, kg, dev):
    """[shard], the KG: `ShardedKGSearch` over [kg]'s store on
    SHARD_KG_QUERIES queries (entity rows plus noise): bf16 against
    `KGStore.search_across_spaces`, capacity mode against the same
    capacity-mode search on a CPU mesh (its overlap with the bf16 top-K
    is printed as a quality figure)."""
    import torch

    from rag_application_tpu_torch.kg.store import Space
    from rag_application_tpu_torch.parallel.kg import ShardedKGSearch
    from rag_application_tpu_torch.parallel.mesh import make_mesh

    ents = kg.spaces[Space.ENTITY].index
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = torch.randint(0, ents.size, (SHARD_KG_QUERIES,), generator=gen,
                         device=dev)
    q = (ents.vecs[rows].float() + 0.02 * torch.randn(
        (SHARD_KG_QUERIES, ents.cfg.dim), generator=gen,
        device=dev)).cpu().numpy()
    cpu_mesh = make_mesh(SHARDS, devices=["cpu"] * SHARDS)
    for capacity in (False, True):
        t0 = time.perf_counter()
        sharded = ShardedKGSearch(kg, mesh, capacity=capacity)
        torch.cuda.synchronize()
        snap = time.perf_counter() - t0
        sizes = {s.value: (t["size"], t["rps"])
                 for s, t in sharded.placed["spaces"].items()}
        ref = ShardedKGSearch(kg, cpu_mesh, capacity=True) if capacity \
            else kg
        ties, overlap, t_sh, t_ref = 0, [], 0.0, 0.0
        for i in range(SHARD_KG_QUERIES):
            t0 = time.perf_counter()
            got = sharded.search_across_spaces(q[i], k=K)
            t_sh += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = ref.search_across_spaces(q[i], k=K)
            t_ref += time.perf_counter() - t0
            ties += shard_hits_equal(got, want, f"[shard] kg query {i} "
                                     f"(capacity {capacity})")
            if capacity:
                a = {(h["space"], h["row"]) for h in got}
                b = {(h["space"], h["row"]) for h in
                     kg.search_across_spaces(q[i], k=K)}
                overlap.append(len(a & b) / max(len(b), 1))
        mode = "capacity (int8)" if capacity else "bf16"
        log(f"  ShardedKGSearch {mode}: snapshot {snap:.2f} s, spaces "
            f"(size, rows a shard) {sizes}; search_across_spaces "
            f"{t_sh / SHARD_KG_QUERIES * 1e3:.2f} ms a query (host clock) "
            f"against {t_ref / SHARD_KG_QUERIES * 1e3:.2f} ms for "
            + (f"the same on a CPU mesh; hits equal to it, {ties} queries "
               f"with a near-tie swap; overlap with the bf16 top-{K} "
               f"{np.mean(overlap):.4f} (min {min(overlap):.2f})"
               if capacity else
               f"one device; hits equal, {ties} queries with a near-tie "
               f"swap"))
        del sharded, ref


def run_shard_ivf(mesh, dev):
    """[shard], IVF: [ann]'s corpus cut into SHARDS partitions at [ann]'s
    settings, `sharded_ivf_search` on a batch of ANN_BATCH at probes 32
    and 128 (recall@10 against the exact top-10), and SHARD_IVF_CPU
    queries held to the same partitions on a CPU mesh. Returns the
    corpus's prep launches."""
    import torch

    from rag_application_tpu_torch.parallel import ivf as pivf
    from rag_application_tpu_torch.parallel import mesh as pm

    dense, preps = ann_corpus(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stacked = pivf.build_sharded_ivf(dense, SHARDS, n_clusters=ANN_CLUSTERS,
                                     bucket_rows=ANN_BUCKET, iters=ANN_ITERS)
    placed = pivf.place_sharded_ivf(mesh, stacked)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rid = stacked["bucket_rowids"]
    live = np.sort(rid[rid >= 0])
    if not np.array_equal(live, np.arange(dense.size)):
        raise AssertionError("[shard] the shards' buckets do not cover every "
                             "row once")
    log(f"  build_sharded_ivf over {dense.size:,} x {DIM} ({SHARDS} shards, "
        f"n_clusters {ANN_CLUSTERS}, bucket_rows {ANN_BUCKET}, iters "
        f"{ANN_ITERS}) and place: {build_s:.2f} s; buckets a shard "
        f"{[int(x) for x in stacked['n_buckets']]}; "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB placed")
    rescore = pm.shard_rows(mesh, dense.vecs[:dense.size])
    rng = np.random.default_rng(ANN_SEED)
    rows = torch.from_numpy(rng.choice(dense.size, ANN_BATCH,
                                       replace=False)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(ANN_SEED + 1)
    q = dense.vecs[rows].float() + 0.05 * torch.randn(
        (ANN_BATCH, DIM), generator=gen, device=dev)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    exact = exact_top_ids(dense, q[:N_EVAL], K)
    torch.cuda.reset_peak_memory_stats()
    for probes in (32, 128):
        _, ids = pivf.sharded_ivf_search(mesh, placed, q, K, probes=probes,
                                         rescore_vecs=rescore,
                                         rescore_limit=ANN_RESCORE)
        ids = ids.cpu().numpy()
        recall = float(np.mean([np.isin(exact[i], ids[i]).mean()
                                for i in range(N_EVAL)]))
        ms = cuda_ms(lambda: pivf.sharded_ivf_search(
            mesh, placed, q, K, probes=probes, rescore_vecs=rescore,
            rescore_limit=ANN_RESCORE), reps=3)
        log(f"  probes {probes} a shard: {ms:.3f} ms a batch of {ANN_BATCH} "
            f"(CUDA events, warm); recall@10 vs exact on {N_EVAL} "
            f"{recall:.4f}")
        if probes == 32 and recall < 0.95:
            raise AssertionError(f"[shard] ivf recall@10 {recall:.4f} < 0.95")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"  peak device memory above the corpus during the searches "
        f"{peak:.2f} GiB")

    # the same partitions on a CPU mesh
    t0 = time.perf_counter()
    cpu_mesh = pm.make_mesh(SHARDS, devices=["cpu"] * SHARDS)
    cpu_placed = pivf.place_sharded_ivf(cpu_mesh, stacked)
    cpu_rescore = [t.cpu() for t in rescore]
    qs = q[:SHARD_IVF_CPU]
    for probes, rs in ((32, False), (128, False), (32, True), (128, True)):
        kw = dict(rescore_vecs=rescore, rescore_limit=ANN_RESCORE) \
            if rs else {}
        dv_, di = pivf.sharded_ivf_search(mesh, placed, qs, K,
                                          probes=probes, **kw)
        if rs:
            kw["rescore_vecs"] = cpu_rescore
        cv, ci = pivf.sharded_ivf_search(cpu_mesh, cpu_placed, qs.cpu(), K,
                                         probes=probes, **kw)
        if not rs:
            if not (bits_equal(di, ci) and bits_equal(dv_, cv)):
                raise AssertionError(f"[shard] ivf probes {probes}: the "
                                     f"card's int8 stage != the CPU's")
            continue
        di, dv_ = di.cpu().numpy(), dv_.cpu().numpy()
        ci, cv = ci.numpy(), cv.numpy()
        for r in range(SHARD_IVF_CPU):
            if not rescored_agree(di[r], dv_[r], ci[r], cv[r], 1e-6):
                raise AssertionError(f"[shard] ivf probes {probes}, query "
                                     f"{r}, rescored: the card != the CPU")
    log(f"  {SHARD_IVF_CPU} queries at probes 32 and 128: int8-stage ids and "
        f"scores bit-equal to the same partitions on a CPU mesh, rescored "
        f"ids equal but at near-ties (1e-6) ({time.perf_counter() - t0:.1f} "
        f"s)")
    del dense, placed, cpu_placed, cpu_rescore, rescore
    torch.cuda.empty_cache()
    return preps


def run_shard(dense, sparse, tokens, kg, dev):
    """[shard]: corpus-axis sharding on a mesh of SHARDS shards on this
    card — the funnel, the KG and IVF — then the two dry runs. Returns
    (the sharded funnel's bm25 match launches, their max abs error, the
    prep launches of the corpus IVF is cut from); the one-device
    reference and the dry runs launch outside these counts."""
    import torch

    from rag_application_tpu_torch.ops import bm25 as ob
    from rag_application_tpu_torch.ops import quant as oq
    from rag_application_tpu_torch.parallel.kg import sharded_kg_dryrun
    from rag_application_tpu_torch.parallel.mesh import make_mesh
    from rag_application_tpu_torch.parallel.search import sharded_topk_dryrun

    mesh = make_mesh(SHARDS, devices=[dev] * SHARDS)
    t0 = time.perf_counter()
    matches, err = run_shard_funnel(mesh, dense, sparse, tokens,
                                    np.random.default_rng(29))
    log(f"  funnel {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_shard_kg(mesh, kg, dev)
    log(f"  kg {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    preps = run_shard_ivf(mesh, dev)
    log(f"  ivf {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ob.bm25_match_rows.launches = 0
    oq.prepare_vectors_into.launches = 0
    sharded_topk_dryrun(mesh)
    sharded_kg_dryrun(mesh)
    torch.cuda.synchronize()
    log(f"  sharded_topk_dryrun and sharded_kg_dryrun on {mesh}: passed in "
        f"{time.perf_counter() - t0:.1f} s (bm25_match "
        f"{ob.bm25_match_rows.launches}, prep_vectors "
        f"{oq.prepare_vectors_into.launches} launches, not counted)")
    log(f"  launches: bm25_match {matches} (the sharded batches), "
        f"prep_vectors {preps} (the IVF corpus's inserts)")
    return matches, err, preps


def shard_phase(dense, sparse, tokens, kg, dev, card):
    """[shard], logged with its time; returns `run_shard`'s."""
    t0 = time.perf_counter()
    log(f"[shard] parallel/*: {SHARDS} shards of slice A's tables, [kg]'s "
        f"store and [ann]'s corpus on one card, batches of {SHARD_BATCH} "
        f"({card})")
    out = run_shard(dense, sparse, tokens, kg, dev)
    log(f"[shard] {time.perf_counter() - t0:.1f} s")
    return out


def shard_only(dev, card) -> int:
    """`--shard`: the main path's tables, [ingest] and [kg], then [shard]
    alone."""
    import torch

    dense, cap, sparse, tokens, rng, t_dense, t_sparse = build_tables(dev)
    del cap
    log(f"[tables] dense {N}x{DIM} built in {t_dense:.1f} s, sparse {N} "
        f"docs in {t_sparse:.1f} s")
    col, emb, _, ing_texts, _, _ = run_ingest(dev)
    t0 = time.perf_counter()
    log(f"[kg] KGStore at the API's width ({card})")
    kg, *_ = run_kg(col, emb, ing_texts, dev)
    log(f"[kg] {time.perf_counter() - t0:.1f} s")
    del col
    torch.cuda.empty_cache()
    shard_phase(dense, sparse, tokens, kg, dev, card)
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
    if sys.argv[1:] == ["--read-path"]:
        return read_path_only(dev, card)
    if sys.argv[1:] == ["--pipeline"]:
        return pipeline_only(dev, card)
    if sys.argv[1:] == ["--ann"]:
        return ann_only(dev, card)
    if sys.argv[1:] == ["--agents"]:
        return agents_only(dev, card)
    if sys.argv[1:] == ["--serve"]:
        return serve_only(dev, card)
    if sys.argv[1:] == ["--batch"]:
        return batch_only(dev, card)
    if sys.argv[1:] == ["--media"]:
        return media_only(dev, card)
    if sys.argv[1:] == ["--train"]:
        return train_only(dev, card)
    if sys.argv[1:] == ["--evals"]:
        return evals_only(dev, card)
    if sys.argv[1:] == ["--shard"]:
        return shard_only(dev, card)

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
    del q, texts, bm25_args  # the tables stay for [shard]
    torch.cuda.empty_cache()

    log("[prep-check] prepare_vectors kernel vs plain on the card")
    prep_err = check_prep(dev)
    log(f"[prep-time] prepare_vectors at the slab, document and one-row "
        f"shapes ({card}); build_tables launched it {table_preps} times")
    _, prep_t, *_ = time_prep(dev)  # the JSON line keeps [ingest]'s shape
    torch.cuda.empty_cache()
    log(f"[ingest] Collection.store_document_vectors(Embedder.encode(...)), "
        f"Config() + EncoderConfig() defaults, {INGEST_DOCS} documents x "
        f"{INGEST_CHUNKS} chunks ({card})")
    col, emb, ing_tokens, ing_texts, prep_launches, ing_rate = run_ingest(
        dev)
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

    errs, prep_err_kg, kg = run_read_path(col, emb, ing_tokens, ing_texts,
                                          dev, card)
    pipe_launches, pipe_errs = pipeline_phase(col, emb, kg, ing_rate, dev,
                                              card)
    ann_preps = ann_phase(col, emb, ing_tokens, dev, card)
    agent_errs, agent_launches, agent_preps = agents_phase(
        col, emb, kg, ing_tokens, dev, card)
    shard_matches, shard_err, shard_preps = shard_phase(
        dense, sparse, tokens, kg, dev, card)
    del dense, sparse, tokens
    torch.cuda.empty_cache()
    scan_err = max(scan_err, errs[0], pipe_errs[0], agent_errs[0])
    scan_bf_err = max(scan_bf_err, errs[1], pipe_errs[1], agent_errs[1])
    bm25_err = max(bm25_err, errs[2], pipe_errs[2], agent_errs[2])
    serve_ckpt = serve_checkpoint(col, kg, emb, dev)
    del col, kg, ing_tokens, ing_texts
    torch.cuda.empty_cache()
    media_launches, media_errs, media_preps = media_phase(dev, card)
    scan_err = max(scan_err, media_errs[0])
    scan_bf_err = max(scan_bf_err, media_errs[1])
    bm25_err = max(bm25_err, media_errs[2])
    eval_launches, eval_errs, eval_preps = evals_phase(dev, card)
    scan_err = max(scan_err, eval_errs[0])
    scan_bf_err = max(scan_bf_err, eval_errs[1])
    bm25_err = max(bm25_err, eval_errs[2], shard_err)
    torch.cuda.empty_cache()

    log("[gen-check] decode_attn kernel vs plain on the card")
    attn_err, attn_args, batch_args = check_decode_attn(dev)
    log(f"[gen-time] decode_attn at the main decode shape, [batch]'s and "
        f"the chat's ({card})")
    attn_t = time_decode_attn(dev, attn_args, batch_args)
    del attn_args, batch_args
    torch.cuda.empty_cache()
    log(f"[gen-main] generate, TinyLlama-1.1B widths, {GEN_B} x {GEN_T} + "
        f"{GEN_NEW}, int8 weights + int8 KV, attn_kernel ({card})")
    params, gcfg, gen_ids, attn_launches = run_generate(dev)
    compare_attention_paths(params, gcfg, gen_ids)
    torch.cuda.empty_cache()
    run_local_llm(params, gcfg, dev)
    torch.cuda.empty_cache()
    batch_launches, batch_attn_err = batch_phase(params, gcfg, dev, card)
    attn_err = max(attn_err, batch_attn_err)
    torch.cuda.empty_cache()
    train_launches, train_attn_err = train_phase(params, gcfg, dev, card)
    attn_err = max(attn_err, train_attn_err)
    serve_errs, serve_launches, serve_attn_err = serve_phase(
        emb, dev, (params, gcfg), serve_ckpt, card)
    scan_err = max(scan_err, serve_errs[0])
    scan_bf_err = max(scan_bf_err, serve_errs[1])
    bm25_err = max(bm25_err, serve_errs[2])
    attn_err = max(attn_err, serve_attn_err)

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
              launches["fused_scan"] + agent_launches["fused_scan"]
              + serve_launches["fused_scan"] + media_launches["fused_scan"]
              + eval_launches["fused_scan"],
              scan_err, scan_t),
        entry("fused_scan_bf16",
              "rag_application_tpu_torch/csrc/fused_scan_bf16.cu",
              "rag_application_tpu/ops/fused_topk.py:61",
              launches["fused_scan_bf16"] + agent_launches["fused_scan_bf16"]
              + serve_launches["fused_scan_bf16"]
              + media_launches["fused_scan_bf16"]
              + eval_launches["fused_scan_bf16"], scan_bf_err, scan_bf_t),
        entry("bm25_match", "rag_application_tpu_torch/csrc/bm25_match.cu",
              "rag_application_tpu/ops/bm25.py:45",
              launches["bm25_match"] + agent_launches["bm25_match"]
              + serve_launches["bm25_match"] + media_launches["bm25_match"]
              + eval_launches["bm25_match"] + shard_matches,
              bm25_err, bm25_t),
        entry("decode_attn", "rag_application_tpu_torch/csrc/decode_attn.cu",
              "rag_application_tpu/ops/decode_attn.py:86",
              attn_launches + batch_launches + train_launches
              + serve_launches["decode_attn"],
              attn_err,
              attn_t),
        entry("prep_vectors", "rag_application_tpu_torch/csrc/prep_vectors.cu",
              "rag_application_tpu/ops/quant.py:66",
              prep_launches + pipe_launches + ann_preps + agent_preps
              + serve_launches["prep_vectors"] + media_preps + eval_preps
              + shard_preps,
              max(prep_err, prep_err_kg),
              prep_t),
    ]}), flush=True)
    log(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
