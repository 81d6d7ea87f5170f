"""Continuous batching for on-device decode (iteration-level scheduling).

Port of `rag_application_tpu/llm/scheduler.py`. The reference's serving
stack answers concurrent chats through Ollama, which batches decode on
the server side; `LocalLLM.chat` alone runs one `generate` per request,
so concurrent requests would serialize on the card. This scheduler lets
N in-flight requests share ONE decode batch, each joining and leaving
without stopping the others.

Design (models/decoder.py):

  * the KV cache keeps the SHARED-SLOT layout: on every step all rows
    write the same physical slot in place. A request's logical positions
    therefore differ from its physical slots; `slot_pos` (B, S) carries
    each slot's true per-row position, and dead slots get 2**30 so no
    later occupant of the row ever attends them;
  * requests JOIN at chunk boundaries: decode runs `chunk` steps a
    dispatch and the host admits and retires requests between chunks.
    Joining costs one single-row prefill pasted into the row;
  * when the write head reaches the cache end, `_compact` re-packs every
    row's live slots to the front (a stable argsort and a gather over
    the slot axis), so the cache bounds CONCURRENT tokens, not the total
    ever decoded.

Where the reference jits each device function (a `lax.scan` over the
chunk's steps, donated buffers), the port runs eager torch ops on the
params' device: Python loops over the steps, caches and row state
updated in place. Every write head is a Python int (a plain step burns
one slot, a speculative step K + 1), so a chunk's steps never wait on
the card; only compaction reads its new head back. With `kv_quant` and
`attn_kernel`, each T = 1 step launches the decode-attention kernel
(ops/decode_attn.py) at B = slots, S = prompt_pad + horizon. CUDA
launches are asynchronous, as JAX dispatch is: each chunk gets its own
output tensor, read back in an executor thread (a non-blocking copy
into pinned memory, then an event), and delivered against the
(row, request_id) snapshot taken at dispatch.

Greedy decode of a request through the batcher gives the tokens of a
solo `generate` run (tests/test_torch_scheduler.py): batching is a
scheduling change, not a model change. Sampled batchers draw from
`torch.Generator`s seeded by (seed, step) and (seed, request id), in
place of the reference's folded JAX keys: the same law, other draws.

Multi-LoRA serving (`lora_banks`, models/lora.py::lora_banks; index 0 =
the base): each request names its adapter (`adapter_id`), a per-slot id
vector rides every prefill and chunk step as the decoder's ``lora``
argument, and rows with different adapters share one batch. An adapter
row never reuses a registered prefix's K/V, which the base computed.

TP-sharded parameters (parallel/tp.py::shard_params) run unchanged: the
decoder's entry points take them, and the batcher's caches, row state
and sampling live on their merge device.

Observability: `stats()` counts steps, tokens, compactions, admissions
and prefix hits (also in /metrics as ``decode_*``). With the tracer on
(`utils.observability.TRACER.enable()`, or any running torch profiler)
a request's life shows as spans: ``batcher.queue`` (submit to its
admission), ``batcher.admit`` (with ``rid``), then, a decode chunk at a
time (with ``chunk``), ``batcher.dispatch``, ``batcher.readback`` and
``batcher.deliver``; ``batcher.compact`` for a compaction. Each closed
span is also ``stage_seconds{stage=<name>}`` in /metrics.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.decoder import (
    DecoderConfig,
    _params_device,
    _project,
    cache_len,
    decode_step,
    forward,
    init_kv_cache,
    prefill,
    sample_logits,
)
from ..utils.observability import METRICS, TRACER

DEAD = 2 ** 30  # slot_pos sentinel: slot holds nothing attendable
NEG = -1.0e30


@dataclass
class _Slot:
    """Host-side bookkeeping for one batch row."""
    request_id: int = -1
    remaining: int = 0
    queue: Optional[asyncio.Queue] = None
    eos_id: int = -1


def _seeded(device: torch.device, seed: int, tag: int
            ) -> torch.Generator:
    """A generator for draw `tag` of a batcher seeded with `seed`, so a
    draw depends on (seed, tag) only, not on what ran before it."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B97F4A7C15 + int(tag)) % (1 << 63))


def _leaves(c: Any) -> List[torch.Tensor]:
    return list(c.values()) if isinstance(c, dict) else [c]


def _paste_row(c: Any, rc: Any, row: int) -> None:
    """Write a (L, 1, n, ...) row cache into row `row`, slots [0, n), of
    a (L, B, S, ...) batch cache, in place; int8 caches leaf by leaf."""
    for d, s in zip(_leaves(c), _leaves(rc)):
        d[:, row, :s.shape[2]] = s[:, 0]


def _commit_row(logits, plen_total: int, rck, rcv, row: int, ck, cv,
                slot_pos, pos, tok, active, temperature: float, top_k: int,
                top_p: float, gen) -> None:
    """Shared admission tail: paste the request's row cache into the
    batch cache, stamp its slot map, and seed pos/tok/active from the
    sampled first token (all in place)."""
    _paste_row(ck, rck, row)
    _paste_row(cv, rcv, row)
    S = slot_pos.shape[1]
    s_idx = torch.arange(S, dtype=torch.int32, device=slot_pos.device)
    slot_pos[row] = torch.where(s_idx < plen_total, s_idx, DEAD)
    pos[row] = plen_total
    first = sample_logits(logits, gen, temperature=temperature, top_k=top_k,
                          top_p=top_p)
    tok[row] = first[0]
    active[row] = True


@torch.no_grad()
def _prefill_row(params, cfg: DecoderConfig, ids: torch.Tensor, plen: int,
                 row: int, ck, cv, slot_pos, pos, tok, active,
                 temperature: float, top_k: int, top_p: float, gen,
                 lora=None) -> None:
    """Admit one request into batch row `row`: run its prompt (B = 1,
    through its adapter's `lora` if any), write the prompt K/V into the
    row's leading slots, reset the row's slot_pos/pos/token/active
    state."""
    dev = ids.device
    rck, rcv = init_kv_cache(cfg, 1, ids.shape[1], device=dev)
    logits, rck, rcv = prefill(
        params, cfg, ids, torch.tensor([plen], dtype=torch.int32,
                                       device=dev), rck, rcv, lora=lora)
    _commit_row(logits, plen, rck, rcv, row, ck, cv, slot_pos, pos, tok,
                active, temperature, top_k, top_p, gen)


@torch.no_grad()
def _prefill_row_prefix(params, cfg: DecoderConfig, pck, pcv,
                        suffix: torch.Tensor, slen: int, row: int, ck, cv,
                        slot_pos, pos, tok, active, temperature: float,
                        top_k: int, top_p: float, gen, lora=None) -> None:
    """Admit a request whose prompt starts with a REGISTERED prefix: the
    prefix's K/V (pck/pcv, (L, 1, p0, KVH, hd)) was computed once at
    registration, so only the suffix runs through the model. The row
    cache is the prefix pasted plus one suffix forward at write_slot=p0
    (slot s = position s throughout, as in a full prefill)."""
    dev = suffix.device
    p0 = cache_len(pck)
    Ts = suffix.shape[1]
    rck, rcv = init_kv_cache(cfg, 1, p0 + Ts, device=dev)
    _paste_row(rck, pck, 0)
    _paste_row(rcv, pcv, 0)
    positions = (p0 + torch.arange(Ts, dtype=torch.int32, device=dev))[None]
    hidden, rck, rcv = forward(params, cfg, suffix, positions, rck, rcv,
                               write_slot=p0, lora=lora)
    logits = _project(params, cfg, hidden[:, slen - 1])
    _commit_row(logits, p0 + slen, rck, rcv, row, ck, cv, slot_pos, pos,
                tok, active, temperature, top_k, top_p, gen)


def _hist_admit(hist: torch.Tensor, ids: torch.Tensor, plen: int, row: int,
                tok: torch.Tensor) -> None:
    """Write an admitted request's prompt + first sampled token into its
    row of the position-indexed history buffer (speculative mode)."""
    hist[row].zero_()
    hist[row, :ids.shape[1]] = ids[0]
    hist[row, plen] = tok[row]


def _spec_draft(hist, tok, pos, K: int):
    """Per-row bigram lookup over the history buffer: the K tokens after
    the latest earlier occurrence of (token at pos - 1, current token);
    rows with no match draft garbage, which verification rejects."""
    HB = hist.shape[1]
    dev = hist.device
    h_idx = torch.arange(HB - 1, dtype=torch.int32, device=dev)
    k_off = torch.arange(K, dtype=torch.int64, device=dev)
    prev = torch.gather(
        hist, 1, torch.clamp(pos - 1, 0, HB - 1).long()[:, None])[:, 0]
    m = ((hist[:, :-1] == prev[:, None])
         & (hist[:, 1:] == tok[:, None])
         & (h_idx[None, :] + 1 < pos[:, None]))
    mi = torch.where(m, h_idx[None, :], -1).amax(dim=1)
    start = torch.clamp(torch.where(mi >= 0, mi + 2, pos + 1), 0, HB - K)
    return torch.gather(hist, 1, start.long()[:, None] + k_off[None, :])


def _spec_accept(blk, draft, temperature, top_k, top_p, gen):
    """(g (B, K+1) int32, a (B,) accepted draft counts 0..K)."""
    K = draft.shape[1]
    if temperature > 0.0:
        # sampled speculation: accept each draft with its target
        # probability, resample rejections from the residual — the
        # emitted law equals plain sampling (models/speculative.py)
        from ..models.speculative import _filtered_probs, _sampled_verify

        probs = _filtered_probs(blk, temperature=temperature, top_k=top_k,
                                top_p=top_p)
        g, accept = _sampled_verify(probs, draft, gen)
    else:
        g = torch.argmax(blk, dim=-1).to(torch.int32)          # (B, K+1)
        accept = draft == g[:, :K]
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    return g, a.to(torch.int32)


def _spec_emit(g, a, positions, active, eos, hist, slot_pos, pos, head):
    """Per-row emission of a verified block (eos consumed, not emitted):
    stamps rejected and inactive slots DEAD, appends the block's tokens
    to each row's history, and returns (emitted (B, K+1) with -1 after
    each row's run, the token after each row's run, next pos,
    still-active)."""
    B, W = g.shape
    K = W - 1
    HB = hist.shape[1]
    k_off = torch.arange(W, dtype=torch.int32, device=g.device)
    in_run = k_off[None, :] <= a[:, None]
    no_eos_before = torch.cumprod(torch.cat(
        [torch.ones((B, 1), dtype=torch.int32, device=g.device),
         (g[:, :-1] != eos[:, None]).to(torch.int32)], dim=1), dim=1)
    ok = in_run & (no_eos_before == 1) & active[:, None]
    emit = ok & (g != eos[:, None])
    emitted = torch.where(emit, g, -1)
    eos_hit = (ok & (g == eos[:, None])).any(dim=1)

    # rejected (and inactive) slots go DEAD so compaction reclaims them;
    # accepted slots keep their positions
    live = in_run & active[:, None]
    slot_pos[:, head:head + W] = torch.where(live, positions, DEAD)

    # append the block's tokens to each row's history (clamped once a
    # request outgrows the buffer — drafts degrade, never results)
    widx = (torch.clamp(pos + 1, 0, HB - W).long()[:, None]
            + k_off.long()[None, :])
    hist.scatter_(1, widx, torch.where(live, g, torch.gather(hist, 1, widx)))

    new_tok = torch.gather(g, 1, a.long()[:, None])[:, 0]
    return (emitted, new_tok, torch.where(active, pos + a + 1, pos),
            active & ~eos_hit)


@torch.no_grad()
def _decode_chunk_spec(params, cfg: DecoderConfig, chunk: int, K: int,
                       tok, pos, active, slot_pos, hist, base_slot: int,
                       eos, ck, cv, temperature: float = 0.0,
                       top_k: int = 64, top_p: float = 1.0,
                       gen_for=None, step0: int = 0, lora=None):
    """`chunk` speculative block steps.

    Each step drafts K tokens per row from the row's own history and
    verifies them plus one correction token in a single (B, K+1)
    forward through the shared-slot cache. Per-row acceptance needs no
    rewind: every step burns K+1 physical slots for every row and each
    row's REJECTED slots are stamped DEAD in its slot_pos lane, so
    compaction reclaims them exactly like retired requests' slots.
    Returns (tok, pos, active, emitted (chunk, B, K+1)): per (step, row)
    a contiguous prefix of real ids then -1 sentinels (eos is consumed,
    never emitted, matching `_decode_chunk`)."""
    B = tok.shape[0]
    dev = tok.device
    k_off = torch.arange(K + 1, dtype=torch.int32, device=dev)
    out = torch.empty((chunk, B, K + 1), dtype=torch.int32, device=dev)
    for j in range(chunk):
        head = base_slot + j * (K + 1)
        draft = _spec_draft(hist, tok, pos, K)                   # (B, K)
        x = torch.cat([tok[:, None], draft], dim=1)              # (B, K+1)
        positions = pos[:, None] + k_off[None, :]
        slot_pos[:, head:head + K + 1] = torch.where(
            active[:, None], positions, DEAD)
        hidden, ck, cv = forward(params, cfg, x, positions, ck, cv,
                                 write_slot=head, slot_positions=slot_pos,
                                 lora=lora)
        blk = _project(params, cfg, hidden)                      # (B,K+1,V)
        gen = None if gen_for is None else gen_for(step0 + j)
        g, a = _spec_accept(blk, draft, temperature, top_k, top_p, gen)
        out[j], tok_n, pos, active_n = _spec_emit(
            g, a, positions, active, eos, hist, slot_pos, pos, head)
        tok = torch.where(active, tok_n, tok)
        active = active_n
    return tok, pos, active, out


def _ext_mask(logits, counts, bias, pres, freq, cstate, cid, cbanks, eos):
    """Per-row extended sampling transform: OpenAI logit_bias (additive)
    + presence/frequency penalties over the row's token counts +
    grammar-constraint mask from the row's DFA state. Bank 0 of `cbanks`
    is permissive (models/constrain.stack_constraints), so a row with
    cid=0 and zero planes gets the identity transform. Matches
    decoder.generate_logprobs's `emit` composition exactly."""
    sample_from = logits + bias.to(logits.dtype)
    sample_from = (sample_from
                   - pres[:, None] * (counts > 0).to(logits.dtype)
                   - freq[:, None] * counts.to(logits.dtype))
    cid, cstate = cid.long(), cstate.long()
    allowed = cbanks["table"][cid, cstate] >= 0                  # (B, V)
    V = logits.shape[-1]
    allowed = allowed | (
        cbanks["accept"][cid, cstate][:, None]
        & (torch.arange(V, device=logits.device)[None, :] == eos[:, None]))
    return torch.where(allowed, sample_from,
                       torch.tensor(NEG, dtype=sample_from.dtype,
                                    device=logits.device))


@torch.no_grad()
def _decode_chunk_spec_ext(params, cfg: DecoderConfig, chunk: int, K: int,
                           tok, pos, active, slot_pos, hist, base_slot: int,
                           eos, ck, cv, temperature: float = 0.0,
                           top_k: int = 64, top_p: float = 1.0,
                           counts=None, bias=None, pres=None, freq=None,
                           cstate=None, cid=None, cbanks=None,
                           gen_for=None, step0: int = 0, lora=None):
    """`_decode_chunk_spec` composed with the extended-sampling transform
    (`_ext_mask`): every verify position i is masked with the DFA state
    and token counts AFTER consuming x_0..x_i — the per-step ordering of
    `_decode_chunk_ext` — so a constrained or penalized request through
    a speculative batcher is greedy-identical to its solo run while
    still accepting multi-token drafts (drafts that would step outside
    the grammar fail argmax agreement and are rejected). Sampled mode
    verifies against the MASKED filtered distribution.

    Returns (tok, pos, active, counts, cstate, emitted (chunk, B, K+1))."""
    B = tok.shape[0]
    V = counts.shape[1]
    dev = tok.device
    k_off = torch.arange(K + 1, dtype=torch.int32, device=dev)
    table = cbanks["table"]
    cid_l = cid.long()
    out = torch.empty((chunk, B, K + 1), dtype=torch.int32, device=dev)
    for j in range(chunk):
        head = base_slot + j * (K + 1)
        draft = _spec_draft(hist, tok, pos, K)
        x = torch.cat([tok[:, None], draft], dim=1)              # (B, K+1)
        positions = pos[:, None] + k_off[None, :]
        slot_pos[:, head:head + K + 1] = torch.where(
            active[:, None], positions, DEAD)
        hidden, ck, cv = forward(params, cfg, x, positions, ck, cv,
                                 write_slot=head, slot_positions=slot_pos,
                                 lora=lora)
        blk = _project(params, cfg, hidden)                      # (B,K+1,V)

        # ---- ext-state evolution along the draft: position i's mask
        # sees counts/DFA state after consuming x_0..x_i
        onehots = torch.nn.functional.one_hot(
            torch.clamp(x, 0, V - 1).long(), V).to(torch.int32)
        cum = torch.cumsum(onehots, dim=1, dtype=torch.int32)    # (B,K+1,V)
        cnts = counts[:, None, :] + cum
        states, c = [], cstate
        for i in range(K + 1):
            c = torch.clamp(table[cid_l, c.long(),
                                  torch.clamp(x[:, i], min=0).long()], min=0)
            states.append(c)
        states = torch.stack(states, dim=1)                      # (B, K+1)
        masked = torch.stack(
            [_ext_mask(blk[:, i], cnts[:, i], bias, pres, freq,
                       states[:, i], cid, cbanks, eos)
             for i in range(K + 1)], dim=1)

        gen = None if gen_for is None else gen_for(step0 + j)
        g, a = _spec_accept(masked, draft, temperature, top_k, top_p, gen)
        out[j], tok_n, pos_n, active_n = _spec_emit(
            g, a, positions, active, eos, hist, slot_pos, pos, head)

        # commit the accepted prefix x_0..x_a into the ext state (a dying
        # row's state is garbage after its latch; re-admission reseeds it)
        take = torch.gather(cum, 1, a.long()[:, None, None].expand(
            B, 1, V))[:, 0]                                      # (B, V)
        counts = counts + torch.where(active[:, None], take, 0)
        new_state = torch.gather(states, 1, a.long()[:, None])[:, 0]
        cstate = torch.where(active, new_state, cstate)
        tok = torch.where(active, tok_n, tok)
        pos, active = pos_n, active_n
    return tok, pos, active, counts, cstate, out


@torch.no_grad()
def _decode_chunk(params, cfg: DecoderConfig, chunk: int, tok, pos, active,
                  slot_pos, base_slot: int, step0: int, temperature: float,
                  top_k: int, top_p: float, eos, gen_for, ck, cv,
                  lora=None):
    """Run `chunk` decode steps for all rows.

    Step j writes every row's K/V at physical slot base_slot + j and
    stamps that slot's per-row position (DEAD for inactive rows). Rows
    latch inactive on eos. Returns (tok, pos, active, tokens (chunk, B)):
    the token CONSUMED at each step is the one reported; the freshly
    sampled token rides the carry for the next step/chunk. `step0` is the
    GLOBAL step counter (monotone across compactions, unlike base_slot)
    so sampling randomness never repeats."""
    B = tok.shape[0]
    out = torch.empty((chunk, B), dtype=torch.int32, device=tok.device)
    for j in range(chunk):
        # the carried token is normally eos-free (a sampled eos latches
        # the row before riding the carry), EXCEPT the prefill-sampled
        # first token — latch on consumption so it is neither delivered
        # nor continued past (decoder.generate's newly_done semantics)
        ok = active & (tok != eos)
        slot_pos[:, base_slot + j] = torch.where(ok, pos, DEAD)
        logits, ck, cv = decode_step(params, cfg, tok, pos, base_slot + j,
                                     ck, cv, slot_positions=slot_pos,
                                     lora=lora)
        nxt = sample_logits(logits, None if gen_for is None
                            else gen_for(step0 + j), temperature=temperature,
                            top_k=top_k, top_p=top_p)
        out[j] = torch.where(ok, tok, -1)
        active = ok & (nxt != eos)
        tok = torch.where(ok, nxt, tok)
        pos = torch.where(ok, pos + 1, pos)
    return tok, pos, active, out


@torch.no_grad()
def _decode_chunk_ext(params, cfg: DecoderConfig, chunk: int, tok, pos,
                      active, slot_pos, base_slot: int, step0: int,
                      temperature: float, top_k: int, top_p: float, eos,
                      gen_for, ck, cv, counts, bias, pres, freq, cstate,
                      cid, cbanks, lora=None):
    """`_decode_chunk` with per-request extended sampling: counts (B, V)
    token counts for the OpenAI penalties (prompt included, seeded at
    admission), bias (B, V) logit_bias planes, pres/freq (B,) penalty
    scalars, cstate/cid (B,) the grammar-DFA state and constraint-bank id
    per row. The consumed token joins the counts and steps the DFA BEFORE
    the next sample — the ordering of the solo loop
    (decoder.generate_logprobs), so a lone request through an ext
    batcher gives the tokens of a solo run with the same knobs.

    Returns (tok, pos, active, counts, cstate, tokens (chunk, B))."""
    B = tok.shape[0]
    dev = tok.device
    rows = torch.arange(B, device=dev)
    table = cbanks["table"]
    cid_l = cid.long()
    out = torch.empty((chunk, B), dtype=torch.int32, device=dev)
    for j in range(chunk):
        ok = active & (tok != eos)
        counts = counts.index_put((rows, tok.long()), ok.to(counts.dtype),
                                  accumulate=True)
        cstate = torch.where(
            ok, table[cid_l, cstate.long(), torch.clamp(tok, min=0).long()],
            cstate)
        cstate = torch.clamp(cstate, min=0)  # never index with DEAD
        slot_pos[:, base_slot + j] = torch.where(ok, pos, DEAD)
        logits, ck, cv = decode_step(params, cfg, tok, pos, base_slot + j,
                                     ck, cv, slot_positions=slot_pos,
                                     lora=lora)
        masked = _ext_mask(logits, counts, bias, pres, freq, cstate, cid,
                           cbanks, eos)
        nxt = sample_logits(masked, None if gen_for is None
                            else gen_for(step0 + j), temperature=temperature,
                            top_k=top_k, top_p=top_p)
        out[j] = torch.where(ok, tok, -1)
        active = ok & (nxt != eos)
        tok = torch.where(ok, nxt, tok)
        pos = torch.where(ok, pos + 1, pos)
    return tok, pos, active, counts, cstate, out


@torch.no_grad()
def _prefill_row_ext(params, cfg: DecoderConfig, ids: torch.Tensor,
                     plen: int, row: int, ck, cv, slot_pos, pos, tok, active,
                     counts, bias, pres, freq, cstate, cid, cbanks,
                     bias_row: torch.Tensor, p: float, f: float, c: int,
                     eos: int, temperature: float, top_k: int, top_p: float,
                     gen, lora=None) -> None:
    """`_prefill_row` for an ext batcher: additionally seeds the row's
    sampling-extension planes (prompt token counts for the penalties,
    logit_bias plane, penalty scalars, DFA state 0 + bank id) and samples
    the FIRST token through the same masked transform the chunk steps
    use. All state is updated in place."""
    dev = ids.device
    T = ids.shape[1]
    rck, rcv = init_kv_cache(cfg, 1, T, device=dev)
    logits, rck, rcv = prefill(
        params, cfg, ids, torch.tensor([plen], dtype=torch.int32,
                                       device=dev), rck, rcv, lora=lora)
    V = counts.shape[1]
    in_prompt = (torch.arange(T, device=dev) < plen).to(counts.dtype)
    rc = torch.zeros((V,), dtype=counts.dtype, device=dev).index_add_(
        0, ids[0].long(), in_prompt)
    counts[row] = rc
    bias[row] = bias_row.to(bias.dtype)
    pres[row] = p
    freq[row] = f
    cstate[row] = 0
    cid[row] = c
    one = lambda v, dt: torch.tensor([v], dtype=dt, device=dev)  # noqa: E731
    # NATIVE logits dtype, as `_decode_chunk_ext` and the solo loop: a
    # cast here could flip the first greedy argmax on near-ties
    masked = _ext_mask(logits, rc[None], bias_row[None].to(bias.dtype),
                       one(p, pres.dtype), one(f, freq.dtype),
                       one(0, cstate.dtype), one(c, cid.dtype), cbanks,
                       one(eos, torch.int64))
    _commit_row(masked, plen, rck, rcv, row, ck, cv, slot_pos, pos, tok,
                active, temperature, top_k, top_p, gen)


def _ext_reset_row(counts, bias, pres, freq, cstate, cid, row: int) -> None:
    """Zero one row's sampling-extension planes (a plain admission into
    an ext batcher reuses the fast `_prefill_row`/prefix paths; this
    clears whatever the row's previous occupant left behind)."""
    for t in (counts, bias, pres, freq, cstate, cid):
        t[row] = 0


@torch.no_grad()
def _compact(ck, cv, slot_pos) -> Tuple[Any, Any, torch.Tensor, int]:
    """Re-pack every row's live slots to the front of the slot axis, in
    place (the cache tensors keep their storage, so CUDA graphs captured
    over them stay valid).

    Order = stable sort by slot position (DEAD slots sink to the end);
    returns the re-packed caches, slot_pos, and the new shared write head
    (max live count over rows — rows with fewer live slots keep a DEAD
    gap, which the mask ignores), read back to the host."""
    with TRACER.span("batcher.compact"):
        order = torch.argsort(slot_pos, dim=1, stable=True)         # (B, S)
        slot_pos = torch.gather(slot_pos, 1, order)

        def gather(c):
            def one(d):
                idx = order.reshape((1,) + order.shape + (1,) * (d.dim() - 3))
                return d.copy_(torch.gather(d, 2, idx.expand(d.shape)))
            return ({k: one(v) for k, v in c.items()} if isinstance(c, dict)
                    else one(c))

        head = int((slot_pos < DEAD).sum(dim=1).max())
        return gather(ck), gather(cv), slot_pos, head


def _readback(out: torch.Tensor, chunk: int) -> np.ndarray:
    """A chunk's output on the host: on the card a non-blocking copy into
    pinned memory behind the chunk's kernels, then an event to wait on.
    ``chunk``: the chunk's number, for its span."""
    with TRACER.span("batcher.readback", chunk=chunk):
        if out.device.type != "cuda":
            return out.numpy().copy()
        with torch.cuda.device(out.device):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        return host.numpy()


class ContinuousBatcher:
    """Async continuous-batching frontend over one decoder + cache.

    `submit` enqueues a prompt and resolves to the generated ids; the
    internal loop admits pending requests into free rows between decode
    chunks. One instance per (params, cfg); all sampling knobs are fixed
    per instance. The device is the params' (a sharded tree's merge
    device)."""

    def __init__(self, params: Dict[str, Any], cfg: DecoderConfig, *,
                 slots: int = 8, prompt_pad: int = 128,
                 horizon: int = 512, chunk: int = 8,
                 temperature: float = 0.0, top_k: int = 64,
                 top_p: float = 1.0, seed: int = 0, spec_k: int = 0,
                 spec_min_tps: float = 0.0, spec_cooldown: int = 16,
                 lookahead: int = 2, lora_banks=None,
                 sampling_ext: bool = False, max_constraints: int = 8):
        if chunk < 1 or horizon < chunk:
            raise ValueError("need chunk >= 1 and horizon >= chunk")
        if cfg.latent and spec_k:
            raise ValueError("speculative decoding (spec_k) is not "
                             "supported with latent attention or experts")
        if cfg.latent and lora_banks is not None:
            raise ValueError("LoRA adapters are not supported with latent "
                             "attention or experts")
        # spec_k works for greedy (argmax-agreement acceptance) AND
        # sampled batchers (rejection-sampled acceptance preserving the
        # filtered distribution exactly); composed with sampling_ext,
        # every verify position applies the grammar/penalty mask before
        # agreement (_decode_chunk_spec_ext)
        self.params, self.cfg = params, cfg
        self.device = _params_device(params)
        # host mirror of each row's constraint id (0 = none): blocks
        # bank-slot eviction while the row decodes, even if the
        # submitting consumer already abandoned its stream
        self._row_cid = np.zeros((slots,), np.int32)
        # multi-LoRA serving: stacked adapter banks (models/lora.py::
        # lora_banks; index 0 = base) and each row's adapter id, which
        # every prefill and chunk step reads as the decoder's `lora`
        self._banks = lora_banks
        self._aid = np.zeros((slots,), np.int32)
        self.B, self.T = slots, prompt_pad
        self.S = prompt_pad + horizon
        self.chunk = chunk
        # spec_k>0: every chunk step verifies spec_k history-drafted
        # tokens + 1 correction per row in ONE forward (_decode_chunk_spec)
        self.spec_k = int(spec_k)
        self.width = self.spec_k + 1  # physical slots burned per step
        if horizon < chunk * self.width:
            raise ValueError("need horizon >= chunk * (spec_k + 1)")
        # adaptive speculation: a speculative dispatch whose realized
        # tokens/step falls below spec_min_tps pauses speculation for
        # spec_cooldown dispatches (a K=0 spec chunk IS a plain chunk
        # under the same output-emission convention, so switching widths
        # per dispatch never changes the emitted tokens). spec_min_tps=0
        # (default) disables throttling.
        self.spec_min_tps = float(spec_min_tps)
        self.spec_cooldown = int(spec_cooldown)
        self._cooldown = 0
        # lookahead: chunks dispatched ahead of the oldest unread chunk
        # OUTPUT. Launches are asynchronous, so with lookahead > 0 the
        # device->host read of chunk k overlaps the launches and device
        # work of chunks k+1..k+L. Safety: a chunk's output is delivered
        # against a (row, request_id) snapshot taken at dispatch, so a
        # row retired + re-admitted while its old chunk was in flight
        # never leaks tokens to the new request. lookahead=0 reads each
        # chunk back before dispatching the next.
        self.lookahead = max(0, int(lookahead))
        self.spec_dispatches = 0
        self.plain_dispatches = 0
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.seed = int(seed)
        # per-request extended sampling (sampling_ext=True): grammar
        # constraints + OpenAI penalties + logit_bias ride per-row device
        # planes through `_decode_chunk_ext` — constrained requests BATCH
        # with plain ones instead of falling back to the solo path
        # (LocalLLM.chat routes accordingly).
        self.sampling_ext = bool(sampling_ext)
        # constraint bank: FIXED-CAPACITY slot array with LRU eviction
        # (holding every schema's (S, V) table on the device forever
        # would grow without bound). Slots are memoized by table digest;
        # eviction skips slots pinned by live/pending requests. Both bank
        # axes are bucketed to powers of two, as in the reference, so the
        # device shape changes at most O(log) times over the batcher's
        # life.
        if max_constraints < 1:
            raise ValueError("max_constraints must be >= 1")
        self.max_constraints = int(max_constraints)
        self._cslots: List[Optional[Any]] = []
        self._cdigest: Dict[str, int] = {}   # table digest -> slot
        self._cuse: Dict[int, int] = {}      # slot -> lru tick
        self._ctick = 0
        self._cpins: Dict[int, int] = {}     # cid -> live/pending refs
        self._smax_bucket = 1                # monotone states bucket
        self._cbanks = None
        if self.sampling_ext:
            self._restack_constraints()
        self._reset_device_state()
        self._slots = [_Slot() for _ in range(slots)]
        # (request id, prompt ids, max_new, eos_id, queue, adapter id, ext,
        #  the request's `batcher.queue` span, open from its submit)
        self._pending: asyncio.Queue = asyncio.Queue()
        self._next_id = 0
        self._task: Optional[asyncio.Task] = None
        self.steps = 0
        self.compactions = 0
        self.tokens_out = 0  # delivered ids (speculative tokens/step =
        #                      tokens_out/steps; ~1 without spec_k)
        self._prefixes: List[Tuple[Tuple[int, ...], Any, Any]] = []
        self.admissions = 0
        self.prefix_hits = 0
        self.prefix_tokens = 0  # prompt tokens served from a cached prefix

    def _gen_for(self, tag: int) -> Optional[torch.Generator]:
        """The generator for draw `tag` (None when greedy: no draws)."""
        if self.temperature == 0.0:
            return None
        return _seeded(self.device, self.seed, tag)

    @torch.no_grad()
    def register_prefix(self, prefix_ids: Sequence[int]) -> None:
        """Precompute and pin the K/V of a shared prompt prefix (e.g. the
        rendered system preamble). Admissions whose prompt starts with it
        skip recomputing those positions — only the suffix runs through
        the model (prefix caching, sized to the RAG serving pattern of one
        constant header + variable question)."""
        ids = [int(t) for t in prefix_ids]
        p0 = len(ids)
        if not 2 <= p0 < self.T:
            raise ValueError("prefix needs 2 <= len < prompt_pad")
        Pb = 1
        while Pb < p0:
            Pb <<= 1
        padded = np.zeros((1, Pb), np.int32)
        padded[0, :p0] = ids
        pck, pcv = init_kv_cache(self.cfg, 1, Pb, device=self.device)
        _, pck, pcv = prefill(
            self.params, self.cfg, torch.as_tensor(padded, device=self.device),
            torch.tensor([p0], dtype=torch.int32, device=self.device),
            pck, pcv)

        def cut(c):
            return ({k: v[:, :, :p0].contiguous() for k, v in c.items()}
                    if isinstance(c, dict) else c[:, :, :p0].contiguous())

        self._prefixes.append((tuple(ids), cut(pck), cut(pcv)))
        self._prefixes.sort(key=lambda e: -len(e[0]))  # longest wins

    def stats(self) -> Dict[str, float]:
        """Serving counters (also pushed to utils.observability.METRICS
        as decode_* by the loop): ``admissions``, and of them
        ``prefix_hits`` that reused a registered prefix's K/V, with
        ``prefix_tokens`` the prompt tokens served from it. A model with
        experts adds the process's ``moe_routed_pairs`` and
        ``moe_experts_hit`` (models/moe.py; the latter as of the newest
        copy the card has finished, read without waiting on it)."""
        out = {"steps": self.steps, "compactions": self.compactions,
               "tokens_out": self.tokens_out,
               "tokens_per_step": (self.tokens_out / self.steps
                                   if self.steps else 0.0),
               "admissions": self.admissions,
               "prefix_hits": self.prefix_hits,
               "prefix_tokens": self.prefix_tokens}
        if self.cfg.n_routed_experts:
            from ..models import moe

            out.update(moe_routed_pairs=moe.routed_pairs(),
                       moe_experts_hit=moe.experts_hit())
        return out

    # ------------------------------------------------------------ public

    async def submit(self, prompt_ids: Sequence[int], *, max_new: int = 128,
                     eos_id: int = -1, adapter_id: int = 0,
                     constraint_id: int = 0, presence: float = 0.0,
                     frequency: float = 0.0,
                     logit_bias=None) -> List[int]:
        """Generate up to `max_new` tokens for one prompt; returns the
        emitted ids (eos excluded). Concurrency-safe: callers share the
        batch. `adapter_id` indexes the instance's LoRA banks (0 = the
        base model): rows with different adapters decode together.
        `constraint_id` (register_constraint),
        presence/frequency and logit_bias ((V,) additive plane) need
        sampling_ext=True; such requests still share the batch with plain
        ones."""
        out: List[int] = []
        async for t in self.submit_stream(prompt_ids, max_new=max_new,
                                          eos_id=eos_id,
                                          adapter_id=adapter_id,
                                          constraint_id=constraint_id,
                                          presence=presence,
                                          frequency=frequency,
                                          logit_bias=logit_bias):
            out.append(t)
        return out

    async def submit_stream(self, prompt_ids: Sequence[int], *,
                            max_new: int = 128, eos_id: int = -1,
                            adapter_id: int = 0, constraint_id: int = 0,
                            presence: float = 0.0, frequency: float = 0.0,
                            logit_bias=None):
        """Like `submit` but yields each token id as soon as its decode
        chunk lands — N concurrent streams share one decode batch
        (time-to-next-token is bounded by chunk size, not by the other
        streams' completions)."""
        ids = list(prompt_ids)[-self.T:]
        if not ids:
            raise ValueError("empty prompt")
        n_adapters = (0 if not self._banks else
                      next(iter(self._banks.values()))["a"].shape[1] - 1)
        if not 0 <= adapter_id <= n_adapters:
            raise ValueError(f"adapter_id {adapter_id} out of range "
                             f"(have {n_adapters} adapters)")
        ext = None
        wants_ext = (constraint_id or presence or frequency
                     or logit_bias is not None)
        if wants_ext and not self.sampling_ext:
            raise ValueError("constraint/penalties/logit_bias need a "
                             "batcher built with sampling_ext=True")
        if wants_ext:
            if constraint_id and not (
                    0 < constraint_id <= len(self._cslots)
                    and self._cslots[constraint_id - 1] is not None):
                raise ValueError(
                    f"constraint_id {constraint_id} is not a registered "
                    f"bank slot (have {len(self._cslots)})")
            vec = np.zeros((self.cfg.vocab_size,), np.float32)
            if logit_bias is not None:
                lb = np.asarray(logit_bias, np.float32)
                if lb.shape != vec.shape:
                    raise ValueError(
                        f"logit_bias must be ({self.cfg.vocab_size},)")
                vec = lb
            ext = (int(constraint_id), float(presence), float(frequency),
                   vec)
            if constraint_id:
                # pin the bank slot for the request's whole life (pending
                # + decoding) so LRU eviction never swaps the grammar out
                # from under an in-flight cid
                self._cpins[int(constraint_id)] = (
                    self._cpins.get(int(constraint_id), 0) + 1)
                self._ctick += 1
                self._cuse[int(constraint_id) - 1] = self._ctick
        q: asyncio.Queue = asyncio.Queue()
        rid = self._next_id
        self._next_id += 1
        try:
            await self._pending.put((rid, ids, int(max_new), int(eos_id), q,
                                     int(adapter_id), ext,
                                     TRACER.open("batcher.queue", rid=rid)))
            self._ensure_loop()
            while True:
                t = await q.get()
                if t is None:
                    return
                if isinstance(t, BaseException):
                    raise t
                yield t
        finally:
            if ext is not None and ext[0]:
                n = self._cpins.get(ext[0], 0) - 1
                if n > 0:
                    self._cpins[ext[0]] = n
                else:
                    self._cpins.pop(ext[0], None)

    # ---------------------------------------------------------- internals

    def _reset_device_state(self) -> None:
        """Fresh cache + row state. Also the failure-recovery path: a loop
        that died mid-chunk may have left the cache half-written, so
        recovery re-initializes rather than reuses it."""
        dev = self.device
        self.ck, self.cv = init_kv_cache(self.cfg, self.B, self.S, device=dev)
        self.slot_pos = torch.full((self.B, self.S), DEAD, dtype=torch.int32,
                                   device=dev)
        self.pos = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        self.tok = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        self.head = self.T  # next physical write slot (shared)
        # speculative mode: per-row position-indexed token history (the
        # draft source). Requests outgrowing it keep decoding correctly
        # — only their draft quality degrades (writes clamp).
        self.hist = (torch.zeros((self.B, self.S + self.width + 1),
                                 dtype=torch.int32, device=dev)
                     if self.spec_k else None)
        if self.sampling_ext:
            V = self.cfg.vocab_size
            self.counts = torch.zeros((self.B, V), dtype=torch.int32,
                                      device=dev)
            self.bias = torch.zeros((self.B, V), dtype=torch.float32,
                                    device=dev)
            self.pres = torch.zeros((self.B,), dtype=torch.float32,
                                    device=dev)
            self.freq = torch.zeros((self.B,), dtype=torch.float32,
                                    device=dev)
            self.cstate = torch.zeros((self.B,), dtype=torch.int32,
                                      device=dev)
            self.cid = torch.zeros((self.B,), dtype=torch.int32, device=dev)

    def _restack_constraints(self) -> None:
        from ..models.constrain import stack_constraints

        # bucket both bank axes to powers of two (capped at
        # max_constraints) so slot fills/evictions keep the device shape
        n = 1
        while n < len(self._cslots):
            n <<= 1
        n = min(max(n, 1), self.max_constraints)
        smax = max([1] + [c.table.shape[0] for c in self._cslots
                          if c is not None])
        while self._smax_bucket < smax:
            self._smax_bucket <<= 1
        self._cbanks = stack_constraints(
            self._cslots, self.cfg.vocab_size, n_banks=n,
            min_states=self._smax_bucket).as_device(self.device)

    @staticmethod
    def _constraint_digest(constraint) -> str:
        d = getattr(constraint, "_digest", None)
        if d is None:
            import hashlib

            h = hashlib.sha1()
            t = np.ascontiguousarray(constraint.table)
            h.update(str(t.shape).encode())
            h.update(t.tobytes())
            h.update(np.ascontiguousarray(constraint.accept).tobytes())
            d = h.hexdigest()
            try:
                constraint._digest = d  # memo on the object (dataclass)
            except AttributeError:
                pass
        return d

    def register_constraint(self, constraint) -> int:
        """Register a compiled grammar (models/constrain.Constraint) for
        per-request constrained decoding; returns its constraint_id for
        `submit`. Registration is memoized by table digest and the bank
        holds at most `max_constraints` slots: a novel schema beyond that
        evicts the least-recently-used slot not pinned by a live or
        pending request, and raises ValueError when every slot is pinned
        (callers fall back to the solo constrained path). Safe to call
        per request — a registered constraint is O(1)."""
        if not self.sampling_ext:
            raise RuntimeError(
                "constraints need a batcher built with sampling_ext=True")
        key = self._constraint_digest(constraint)
        slot = self._cdigest.get(key)
        if slot is not None:
            self._ctick += 1
            self._cuse[slot] = self._ctick
            return slot + 1
        if len(self._cslots) < self.max_constraints:
            slot = len(self._cslots)
            self._cslots.append(None)
        else:
            in_rows = set(int(c) for c in self._row_cid if c)
            evictable = [s for s in range(len(self._cslots))
                         if not self._cpins.get(s + 1)
                         and (s + 1) not in in_rows]
            if not evictable:
                raise ValueError(
                    "constraint bank full: every slot is pinned by a "
                    "live or pending request (raise max_constraints)")
            slot = min(evictable, key=lambda s: self._cuse.get(s, 0))
            old = self._cslots[slot]
            if old is not None:
                self._cdigest.pop(self._constraint_digest(old), None)
        self._cslots[slot] = constraint
        self._cdigest[key] = slot
        self._ctick += 1
        self._cuse[slot] = self._ctick
        self._restack_constraints()
        return slot + 1

    def _ensure_loop(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    def _free_rows(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.queue is None]

    def _lora(self, aid_vec) -> Optional[Dict[str, Any]]:
        """The decoder's ``lora`` argument for rows with adapter ids
        ``aid_vec`` (a copy on the device); None without banks."""
        if self._banks is None:
            return None
        return {"aid": torch.tensor(np.asarray(aid_vec), dtype=torch.int32,
                                    device=self.device),
                "banks": self._banks}

    @torch.no_grad()
    def _admit(self, row: int, rid: int, ids: List[int],
               adapter_id: int = 0, ext=None,
               eos_id: int = -1) -> Optional[int]:
        """Device-side admission (and the spec-mode first-token read).
        Runs in an executor thread; returns the first sampled token in
        speculative mode (else None). Queue-facing state moves in
        `_finish_admit` on the loop thread."""
        with TRACER.span("batcher.admit", rid=rid, row=row,
                         prefix_hit=False, suffix_tokens=len(ids)) as sp:
            dev = self.device
            padded = torch.zeros((1, self.T), dtype=torch.int32)
            padded[0, :len(ids)] = torch.as_tensor(ids, dtype=torch.int32)
            padded = padded.to(dev)
            gen = self._gen_for(2 ** 20 + rid)
            self._aid[row] = adapter_id
            self._row_cid[row] = ext[0] if ext is not None else 0
            row_lora = self._lora([adapter_id])
            state = (self.ck, self.cv, self.slot_pos, self.pos, self.tok,
                     self.active)
            knobs = (self.temperature, self.top_k, self.top_p, gen)
            if ext is not None:
                # extended-sampling admission: seed the row's planes and
                # sample the first token through the same masked transform
                # the chunk steps apply (skips the prefix-cache fast path —
                # the penalties need the row's full prompt counts anyway)
                c, p, f, vec = ext
                _prefill_row_ext(
                    self.params, self.cfg, padded, len(ids), row, *state,
                    self.counts, self.bias, self.pres, self.freq, self.cstate,
                    self.cid, self._cbanks, torch.as_tensor(vec, device=dev),
                    p, f, c, eos_id, *knobs, row_lora)
            else:
                if self.sampling_ext:
                    # plain admission into an ext batcher: the fast paths
                    # below sample the first token unmasked (identical law
                    # — zero planes are the identity transform); just clear
                    # whatever the row's previous occupant left in the
                    # planes
                    _ext_reset_row(self.counts, self.bias, self.pres,
                                   self.freq, self.cstate, self.cid, row)
                # prefix K/V were computed through the BASE model: an
                # adapter changes every projection, so adapter rows take a
                # full prefill
                match = None if adapter_id != 0 else next(
                    ((pids, pck, pcv) for pids, pck, pcv in self._prefixes
                     if len(ids) > len(pids)
                     and tuple(ids[:len(pids)]) == pids), None)
                if match is not None:
                    pids, pck, pcv = match
                    sfx = ids[len(pids):]
                    Ts = 1
                    while Ts < len(sfx):
                        Ts <<= 1
                    # the p0+Ts row buffer must paste inside the S-slot
                    # axis; a long suffix after a long prefix can overshoot
                    # the pow2 pad — fall back to a full prefill rather
                    # than fail
                    if len(pids) + Ts > self.S:
                        match = None
                if match is not None:
                    spad = torch.zeros((1, Ts), dtype=torch.int32)
                    spad[0, :len(sfx)] = torch.as_tensor(sfx,
                                                         dtype=torch.int32)
                    _prefill_row_prefix(self.params, self.cfg, pck, pcv,
                                        spad.to(dev), len(sfx), row, *state,
                                        *knobs, row_lora)
                    self.prefix_hits += 1
                    self.prefix_tokens += len(pids)
                    METRICS.inc("decode_prefix_hits")
                    METRICS.inc("decode_prefix_tokens", len(pids))
                    sp.set(prefix_hit=True, suffix_tokens=len(sfx))
                else:
                    _prefill_row(self.params, self.cfg, padded, len(ids), row,
                                 *state, *knobs, row_lora)
            # the shared write head must never re-enter a live prompt range
            # (possible after compaction shrank it): decode writes hit EVERY
            # row at the shared slot and would clobber this prompt's K/V.
            self.head = max(self.head, len(ids))
            self.admissions += 1
            METRICS.inc("decode_admissions")
            if self.spec_k:
                # speculative batchers draft from per-row history and deliver
                # the prefill-sampled first token at admission
                _hist_admit(self.hist, padded, len(ids), row, self.tok)
                return int(self.tok[row])
            return None

    def _finish_admit(self, row: int, rid: int, max_new: int,
                      eos_id: int, q: asyncio.Queue,
                      first: Optional[int]) -> None:
        """Queue-facing admission bookkeeping. Runs on the EVENT-LOOP
        thread (asyncio.Queue.put_nowait is not thread-safe; the device
        work in `_admit` runs in an executor thread)."""
        self._slots[row] = _Slot(rid, max_new, q, eos_id)
        if first is not None:
            # block steps emit their OUTPUTS (g); the prefill-sampled
            # first token is nobody's output, so deliver it here (the
            # plain path instead emits each consumed token one step late,
            # which covers it)
            if first == eos_id or max_new <= 0:
                self._retire(row)
            else:
                q.put_nowait(first)
                self.tokens_out += 1
                self._slots[row].remaining -= 1
                if self._slots[row].remaining == 0:
                    self._retire(row)

    def _retire(self, row: int) -> None:
        s = self._slots[row]
        if s.queue is not None:
            s.queue.put_nowait(None)
        self._slots[row] = _Slot()
        self._aid[row] = 0
        self._row_cid[row] = 0
        self.active[row] = False
        # clear the row's slot map so compaction never counts (and the
        # write head never sits past) a dead request's leftovers
        self.slot_pos[row] = DEAD

    async def _run(self) -> None:
        try:
            await self._serve()
        except asyncio.CancelledError:
            # event-loop teardown (asyncio.run cancels pending tasks):
            # propagate — this is not a serving failure
            raise
        except Exception as exc:  # deliver, never hang submitters
            for s in self._slots:
                if s.queue is not None:
                    s.queue.put_nowait(exc)
            self._slots = [_Slot() for _ in range(self.B)]
            while True:
                try:
                    _, _, _, _, q, _, _, _ = self._pending.get_nowait()
                except asyncio.QueueEmpty:
                    break
                q.put_nowait(exc)
            # the exception now lives with every submitter; re-raising
            # would only leave an unretrieved task exception. Log, restore
            # a clean device state and let the loop die; the next submit
            # restarts it.
            import logging

            logging.getLogger(__name__).exception("batcher loop failed")
            self._reset_device_state()

    def _process(self, entry) -> None:
        """Deliver one read-back chunk output. `entry` is the dispatch-
        time snapshot (host output (chunk, B, W), busy (row, rid) pairs,
        use_k). Runs on the event-loop thread."""
        emitted, busy, use_k = entry
        if self.spec_k and use_k > 0 and self.spec_min_tps > 0 and busy:
            rows = [i for i, _ in busy]
            rate = float((emitted[:, rows, :] >= 0).sum()) / (
                self.chunk * len(rows))
            if rate < self.spec_min_tps:
                self._cooldown = self.spec_cooldown
        for i, rid in busy:
            s = self._slots[i]
            if s.queue is None or s.request_id != rid:
                continue  # retired (and possibly re-admitted) meanwhile
            for j in range(self.chunk):
                if s.remaining == 0:
                    break
                for w in range(emitted.shape[2]):
                    t = int(emitted[j, i, w])
                    if t < 0 or s.remaining == 0:
                        # -1 ends this BLOCK's run, not the row: later
                        # steps in the chunk may emit more
                        break
                    s.queue.put_nowait(t)
                    s.remaining -= 1
                    self.tokens_out += 1
            # row death is derived from the output itself (the live
            # device `active` may already reflect LATER in-flight
            # chunks): a row alive through the chunk's last step emits a
            # real id at (last, 0) in both plain and spec modes, so -1
            # there means the row was dead (or died consuming eos) by the
            # end of THIS chunk. A row that dies by SAMPLING eos at the
            # last step shows up one chunk later — one wasted dispatch,
            # never a wrong token.
            if s.remaining == 0 or int(emitted[-1, i, 0]) < 0:
                self._retire(i)
        METRICS.inc("decode_steps", self.chunk)
        METRICS.set_gauge("decode_tokens_per_step",
                          self.tokens_out / max(self.steps, 1))
        METRICS.set_gauge("decode_active_rows", len(busy))
        if self.cfg.n_routed_experts:
            from ..models import moe

            moe.experts_hit()  # its newest finished copy into METRICS

    def _step(self, use_k: int, eos_vec: np.ndarray,
              rows: int) -> torch.Tensor:
        """Issue one chunk from an executor thread and return its OUTPUT
        tensor (chunk, B, W) without waiting for the card: a fresh tensor
        no later chunk writes, so its read can float in its own thread
        while further chunks launch. ``rows``: the busy rows, for its
        span."""
        with TRACER.span("batcher.dispatch",
                         chunk=self.steps // self.chunk, rows=rows):
            eos = torch.as_tensor(eos_vec, device=self.device)
            base = (self.params, self.cfg, self.chunk)
            lora = self._lora(self._aid)
            if self.spec_k and self.sampling_ext:
                (self.tok, self.pos, self.active, self.counts, self.cstate,
                 out) = _decode_chunk_spec_ext(
                    *base, use_k, self.tok, self.pos, self.active,
                    self.slot_pos, self.hist, self.head, eos, self.ck,
                    self.cv, self.temperature, self.top_k, self.top_p,
                    self.counts,
                    self.bias, self.pres, self.freq, self.cstate, self.cid,
                    self._cbanks, self._gen_for, self.steps, lora)
                return out                          # (chunk, B, K+1)
            if self.spec_k:
                self.tok, self.pos, self.active, out = _decode_chunk_spec(
                    *base, use_k, self.tok, self.pos, self.active,
                    self.slot_pos, self.hist, self.head, eos, self.ck,
                    self.cv, self.temperature, self.top_k, self.top_p,
                    self._gen_for, self.steps, lora)
                return out                          # (chunk, B, K+1)
            if self.sampling_ext:
                (self.tok, self.pos, self.active, self.counts, self.cstate,
                 out) = _decode_chunk_ext(
                    *base, self.tok, self.pos, self.active, self.slot_pos,
                    self.head, self.steps, self.temperature, self.top_k,
                    self.top_p, eos, self._gen_for, self.ck, self.cv,
                    self.counts, self.bias, self.pres, self.freq,
                    self.cstate, self.cid, self._cbanks, lora)
                return out[:, :, None]              # (chunk, B, 1)
            self.tok, self.pos, self.active, out = _decode_chunk(
                *base, self.tok, self.pos, self.active, self.slot_pos,
                self.head, self.steps, self.temperature, self.top_k,
                self.top_p, eos, self._gen_for, self.ck, self.cv, lora)
            return out[:, :, None]                  # (chunk, B, 1)

    async def _serve(self) -> None:
        loop = asyncio.get_running_loop()
        # in-flight chunk outputs: (readback future -> np (chunk, B, W),
        # busy snapshot [(row, rid)], use_k, chunk number), oldest first
        inflight: List[Tuple[asyncio.Future, List[Tuple[int, int]], int,
                             int]] = []

        async def _pop_oldest():
            fut, busy, use_k, chunk = inflight.pop(0)
            emitted = await fut
            with TRACER.span("batcher.deliver", chunk=chunk):
                self._process((emitted, busy, use_k))

        try:
            while True:
                # admit as many pending requests as there are free rows
                admitted = False
                for row in self._free_rows():
                    try:
                        (rid, ids, max_new, eos_id, q, adapter_id,
                         ext, queued) = self._pending.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    queued.close()
                    first = await loop.run_in_executor(
                        None, self._admit, row, rid, ids, adapter_id, ext,
                        eos_id)
                    self._finish_admit(row, rid, max_new, eos_id, q, first)
                    admitted = True
                busy = [(i, s.request_id) for i, s in enumerate(self._slots)
                        if s.queue is not None]
                if not busy:
                    if inflight:
                        await _pop_oldest()
                        continue
                    if admitted:
                        continue
                    return  # nothing in flight; next submit restarts
                # adaptive speculation: during a cooldown run K=0 spec
                # chunks (same emission convention, 1 slot/step) and
                # re-probe speculation when it expires. With lookahead the
                # low-rate signal arrives up to `lookahead` dispatches
                # late (the rate is only known at readback).
                use_k = self.spec_k
                throttled = (use_k and self.spec_min_tps > 0
                             and self._cooldown > 0)
                if throttled:
                    use_k = 0
                burn = self.chunk * (use_k + 1)  # slots per dispatch
                if self.head + burn > self.S:
                    # process every in-flight output first: rows that died
                    # in those chunks retire HERE, clearing their slot_pos
                    # lanes so compaction actually reclaims them
                    while inflight:
                        await _pop_oldest()
                    # the output-derived retire misses one case: a row
                    # whose chunk sampled eos at its LAST step is dead on
                    # the device but host-busy, and its un-cleared lane
                    # would survive compaction (spuriously "cache full").
                    # At this sync point, read the live active vector and
                    # retire device-dead rows before re-packing.
                    alive = await loop.run_in_executor(
                        None, lambda: self.active.cpu().numpy())
                    for i, s in enumerate(self._slots):
                        if s.queue is not None and not alive[i]:
                            self._retire(i)
                    busy = [(i, s.request_id)
                            for i, s in enumerate(self._slots)
                            if s.queue is not None]
                    if not busy:
                        continue  # drain/retire freed every row
                    (self.ck, self.cv, self.slot_pos,
                     self.head) = await loop.run_in_executor(
                        None, _compact, self.ck, self.cv, self.slot_pos)
                    self.compactions += 1
                    if self.head + burn > self.S:
                        raise RuntimeError(
                            "cache full after compaction: concurrent live "
                            "tokens exceed prompt_pad+horizon; raise "
                            "horizon or lower max_new")
                if throttled:
                    # decrement only when the K=0 probe chunk actually
                    # dispatches (the compaction branch may `continue`)
                    self._cooldown -= 1
                eos_vec = np.full((self.B,), -2, np.int32)
                for i, _ in busy:
                    eos_vec[i] = self._slots[i].eos_id

                chunk = self.steps // self.chunk
                out = await loop.run_in_executor(None, self._step, use_k,
                                                 eos_vec, len(busy))
                self.head += burn
                self.steps += self.chunk
                if self.spec_k:
                    if use_k > 0:
                        self.spec_dispatches += 1
                    else:
                        self.plain_dispatches += 1
                inflight.append((loop.run_in_executor(None, _readback, out,
                                                      chunk),
                                 busy, use_k, chunk))
                while len(inflight) > self.lookahead:
                    await _pop_oldest()
        finally:
            # surface in-flight readbacks before the loop exits (error
            # path: _run resets device state; an unawaited future that
            # fails later would be dumped as "exception never retrieved")
            for fut, _, _, _ in inflight:
                fut.cancel()
                try:
                    await fut
                except (Exception, asyncio.CancelledError):
                    pass
