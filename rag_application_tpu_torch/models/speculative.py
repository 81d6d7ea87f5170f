"""Prompt-lookup speculative decoding: lossless speedup, greedy or sampled.

Port of `rag_application_tpu/models/speculative.py`. RAG completions are
copy-heavy (answers quote the retrieved context), so the next tokens are
often already in the sequence. Each block drafts K of them from the
sequence itself (prompt lookup: the continuation of the latest earlier
occurrence of the current bigram) and verifies the K drafts plus one
token in ONE decoder forward at T = K + 1. Accepted drafts cost one step
instead of one step each; a rejection costs nothing extra (the
correction token came out of the same forward).

Greedy output is the argmax of the same logits as `decoder.generate`'s;
sampled output (temperature > 0) draws from the identical filtered
distribution through rejection-sampled acceptance (`_sampled_verify`),
so drafting changes the schedule, never the law. The random stream is a
`torch.Generator`'s, not `jax.random`'s: sampled tokens follow the same
law as the reference's, from other draws.

Where the reference runs the whole loop as one `lax.while_loop`, the
port runs one eager forward a block on the params' device and reads the
block's verdict back to the host: the head advances by accepted + 1, so
each block waits on the one before it (inherent to speculation at
B = 1). The history buffer the bigram search reads stays on the host as
a numpy array (a vectorized compare). The cache keeps the decoder's
shared-slot layout: a block writes slots [head, head + K] in place and
its rejected slots are overwritten by the next block, so no rollback
ever touches the cache. Blocks run the decoder's einsum attention (the
decode-attention kernel takes one token a row).

Single-row only (B = 1): speculation is a latency tool for interactive
streams; batch throughput is the continuous batcher's job
(llm/scheduler.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .decoder import (
    DecoderConfig,
    _as_tensor,
    _params_device,
    _project,
    forward,
    init_kv_cache,
    prefill,
    sample_logits,
    topk_logits,
)

DEAD = 2 ** 30  # slot_positions sentinel (matches llm/scheduler.py)


def _filtered_probs(logits: torch.Tensor, *, temperature: float, top_k: int,
                    top_p: float) -> torch.Tensor:
    """The exact full-vocab distribution `decoder.sample_logits` draws
    from: temperature -> top-k -> nucleus within the top-k, renormalized
    (everything outside gets probability 0). Any leading axes."""
    vals, idx = topk_logits(logits / temperature, top_k)  # sorted desc
    if top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = (csum - probs) < top_p  # first token always kept
        vals = torch.where(keep, vals, -torch.inf)
    kept = torch.softmax(vals, dim=-1)
    return torch.zeros_like(logits, dtype=kept.dtype).scatter_(-1, idx, kept)


def _sampled_verify(probs: torch.Tensor, draft: torch.Tensor,
                    generator: Optional[torch.Generator]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampling verification of a deterministic draft.

    probs (..., K+1, V): the target distributions at each block position
    (position j conditions on draft[:j]); draft (..., K). The drafted
    proposal is a point mass, so speculative sampling reduces to: accept
    draft[j] with probability p_j(draft[j]); on the first rejection, draw
    from p_j with the drafted token REMOVED and renormalized (the
    positive residual (p - q)+). The emitted marginal equals p_j exactly:
    p(d) * delta_d + (1 - p(d)) * p|!d = p. Position K (the bonus token)
    has no draft: a plain draw from p_K.

    Returns (g (..., K+1) int32 tokens, accept (..., K) bool flags)."""
    K = draft.shape[-1]
    d = draft.long()[..., None]
    u = torch.rand(draft.shape, generator=generator, dtype=torch.float32,
                   device=probs.device)
    p_d = torch.gather(probs[..., :K, :], -1, d)[..., 0]
    accept = u < p_d
    residual = probs.clone()
    residual[..., :K, :].scatter_(-1, d, 0.0)  # row K untouched
    # categorical draw (Gumbel-max, as `jax.random.categorical`)
    g_u = torch.rand(residual.shape, generator=generator,
                     dtype=torch.float32, device=probs.device)
    g_u = torch.clamp(g_u, min=torch.finfo(torch.float32).tiny)
    res = torch.argmax(torch.log(torch.clamp(residual, min=1e-38))
                       - torch.log(-torch.log(g_u)), dim=-1).to(torch.int32)
    g = torch.cat([torch.where(accept, draft.to(torch.int32), res[..., :K]),
                   res[..., K:]], dim=-1)
    return g, accept


@torch.no_grad()
def generate_lookup_stats(params: Dict[str, Any], cfg: DecoderConfig,
                          ids, prompt_len, max_new: int, eos_id: int,
                          pad_id: int, rng: Optional[torch.Generator] = None,
                          k_spec: int = 4, temperature: float = 0.0,
                          top_k: int = 64, top_p: float = 1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """`generate_lookup` that also returns the number of decoder block
    steps taken (the prefill counts as one, as in the reference):
    tokens per step is the speedup.

    temperature == 0: greedy — accept the drafts the argmax agrees with.
    temperature > 0: SAMPLED speculation — each draft is accepted with
    the target probability of that token and rejections resample from
    the residual (`_sampled_verify`), so every emitted token is an exact
    draw from the filtered distribution `decoder.generate` samples."""
    sampled = temperature > 0.0
    dev = _params_device(params)
    ids_np = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids,
                        dtype=np.int64)
    plen_np = np.asarray(prompt_len.cpu() if isinstance(
        prompt_len, torch.Tensor) else prompt_len)
    B, T = ids_np.shape
    if B != 1:
        raise ValueError("generate_lookup is single-row (B=1); batches "
                         "belong to the continuous batcher")
    if cfg.latent:
        raise ValueError("speculative decoding is not supported with "
                         "latent attention or experts")
    K = int(k_spec)
    if K < 1:
        raise ValueError("k_spec must be >= 1")
    if sampled and rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    plen = int(plen_np.reshape(-1)[0])

    # cache: prompt block [0, T) + one slot per consumed token. The last
    # block may consume up to K+1 slots while emitting its final token,
    # hence the +K slack; rejected slots are overwritten by later blocks.
    S = T + max_new + K
    cache_k, cache_v = init_kv_cache(cfg, 1, S, device=dev)
    s_idx = torch.arange(S, dtype=torch.int32, device=dev)
    slot_pos = torch.where(s_idx < plen, s_idx, DEAD)[None, :].to(
        torch.int32)

    # position-indexed history: hist[p] = token at position p. Prompt pad
    # positions [plen, T) hold garbage until emissions overwrite them; the
    # bigram search masks anything at positions >= pos. The +K+1 tail
    # keeps the emission block write unclamped at the end.
    HL = T + max_new + K + 1
    hist = np.zeros((HL,), np.int64)
    hist[:T] = ids_np[0]

    logits, cache_k, cache_v = prefill(
        params, cfg, _as_tensor(ids_np, torch.int32, dev),
        _as_tensor(plen_np.reshape(-1), torch.int32, dev), cache_k, cache_v)
    first = int(sample_logits(logits, rng, temperature=temperature,
                              top_k=top_k, top_p=top_p)[0])
    hist[plen] = first

    h_idx = np.arange(HL - 1)
    k_off = np.arange(K + 1)
    e, pos, done, head, steps = 1, plen, first == eos_id, T, 1
    while e < max_new and not done:
        # ---- draft: latest earlier occurrence of the current bigram
        prev, cur = hist[pos - 1], hist[pos]
        m = (hist[:-1] == prev) & (hist[1:] == cur) & (h_idx + 1 < pos)
        start = int(h_idx[m].max()) + 2 if m.any() else pos + 1
        start = min(max(start, 0), HL - K)  # no match: drafts get rejected
        draft = hist[start:start + K]

        # ---- verify K+1 tokens in one decoder forward
        x = torch.as_tensor(np.concatenate([[cur], draft])[None],
                            dtype=torch.int32, device=dev)       # (1, K+1)
        positions = torch.arange(pos, pos + K + 1, dtype=torch.int32,
                                 device=dev)[None]
        slot_pos[:, head:head + K + 1] = positions
        hidden, cache_k, cache_v = forward(
            params, cfg, x, positions, cache_k, cache_v, write_slot=head,
            slot_positions=slot_pos)
        blk = _project(params, cfg, hidden[0])                  # (K+1, V)
        if sampled:
            probs = _filtered_probs(blk, temperature=temperature,
                                    top_k=top_k, top_p=top_p)
            g_t, acc_t = _sampled_verify(
                probs, torch.as_tensor(draft, device=dev), rng)
            g, accept = g_t.cpu().numpy(), acc_t.cpu().numpy()
        else:
            g = torch.argmax(blk, dim=-1).cpu().numpy()        # (K+1,)
            # acceptance: longest draft prefix the model agrees with
            accept = draft == g[:K]
        a = int(np.cumprod(accept.astype(np.int64)).sum())     # 0..K

        # ---- emit g[0..a], clamped by budget and cut at eos
        no_eos_before = np.cumprod(np.concatenate(
            [[1], (g[:-1] != eos_id).astype(np.int64)]))
        emit = (k_off <= a) & (k_off < max_new - e) & (no_eos_before == 1)
        n_new = int(emit.sum())
        eos_hit = bool((emit & (g == eos_id)).any())
        blk_h = hist[pos + 1:pos + K + 2]
        hist[pos + 1:pos + K + 2] = np.where(emit, g, blk_h)

        e, pos = e + n_new, pos + n_new
        done = done or eos_hit
        head += a + 1
        steps += 1

    out = hist[plen:plen + max_new].copy()
    out = np.where(np.arange(max_new) < e, out, pad_id)[None, :]
    out_t = torch.as_tensor(out, dtype=torch.int32)
    return out_t, (out_t != pad_id).sum(dim=1).to(torch.int32), steps


def generate_lookup(params: Dict[str, Any], cfg: DecoderConfig,
                    ids, prompt_len, max_new: int, eos_id: int, pad_id: int,
                    rng: Optional[torch.Generator] = None, k_spec: int = 4,
                    temperature: float = 0.0, top_k: int = 64,
                    top_p: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generation with prompt-lookup drafts. Same contract as
    `decoder.generate`: returns (tokens (1, max_new) int32, pad after
    eos; n_generated (1,)), on the host. Greedy at temperature 0 is the
    argmax of the plain loop's logits; temperature > 0 draws from the
    identical filtered distribution via rejection-sampled verification
    (`rng` seeds it)."""
    out, n, _ = generate_lookup_stats(params, cfg, ids, prompt_len,
                                      max_new, eos_id, pad_id, rng,
                                      k_spec, temperature, top_k, top_p)
    return out, n
