"""Causal LM: LLaMA-family decoder with a static KV cache, in PyTorch.

Port of `rag_application_tpu/models/decoder.py`. The parameters are a
plain dict of tensors in the reference's stacked layout: every per-layer
weight carries a leading (L, ...) axis, and the KV cache is one
`(L, B, S, kv_heads, head_dim)` buffer per K and V (or an
``{"q": int8, "s": f32}`` pair with `kv_quant`). Where the reference runs
its layers under `lax.scan` and its decode under one `lax.while_loop`,
the port runs eager Python loops over views of the stacked tensors:

  * the cache is written IN PLACE — prefill at slots [0, T), decode at
    one shared scalar slot per step for every row (the only write pattern
    that does not rewrite the whole cache per step; the reference
    measured a per-row scatter 13-24x slower). `forward` returns the
    same cache tensors it was given, updated;
  * slot index and token position decouple as in the reference: RoPE
    uses each row's true position, and visibility is
    `slot_positions[b, s] <= query_pos`, with prompt pad slots at 2**30;
  * with `kv_quant` and `attn_kernel`, T = 1 steps on a kernel-tileable
    geometry call `ops/decode_attn.py::decode_attend_int8` (the CUDA
    flash-decode kernel on the card, its plain version on the CPU);
    every other attention runs the einsum path.

Rounding follows the reference: weight-only int8 matmuls are
``(x @ q.to(x.dtype)) * s.to(x.dtype)``; RMSNorm multiplies by its
weight in f32 before the cast; RoPE casts cos/sin to the activation
dtype; attention scores and softmax are f32; int8 rounding is
``round(x / s)`` half-to-even. Sampling uses exact top-k and explicit
`torch.Generator`s: greedy outputs match the reference token for token,
sampled outputs follow the same law from a different random stream.

Not ported yet: per-row LoRA adapters (`lora=`, models/lora.py) and
grammar constraints (`constraint=`, models/constrain.py) raise
`NotImplementedError`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import decode_attn as _da
from ..utils import DeviceLike, resolve_device

NEG = -1.0e30
# generate() reads `done.all()` on the host once per this many steps;
# rows that are done emit only pad, so the outputs do not depend on it
_DONE_CHECK_EVERY = 8


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden: int
    num_layers: int
    heads: int
    kv_heads: int
    mlp_dim: int
    max_len: int = 1024
    rope_theta: float = 10000.0
    # Llama-3-style rope scaling ("llama3") or positional interpolation
    # ("linear"); "none" = plain RoPE.
    rope_kind: str = "none"
    rope_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    eps: float = 1e-6
    dtype: str = "bfloat16"
    # int8 KV cache: K/V rows store int8 with one f32 scale per
    # (slot, kv-head), read back as (int8 @ .) * scale inside attention.
    kv_quant: bool = False
    # Kept for compatibility with the reference's config; has no effect.
    # The reference chooses between an unrolled layer loop and lax.scan;
    # the port's eager loop over views of the stacked cache computes what
    # the unrolled path computes.
    decode_unroll: Optional[bool] = None
    # Fused flash-decode attention for int8 KV caches (T = 1 steps with a
    # kernel-tileable geometry; anything else takes the einsum path).
    attn_kernel: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def q_groups(self) -> int:
        return self.heads // self.kv_heads


def _dtype(cfg: DecoderConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _params_device(params: Dict[str, Any]) -> torch.device:
    emb = params["tok_emb"]
    return (emb["q"] if isinstance(emb, dict) else emb).device


def _as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor or a host array (numpy, list) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _no_lora(lora) -> None:
    if lora is not None:
        raise NotImplementedError(
            "per-row LoRA adapters are not ported yet (models/lora.py)")


# ------------------------------------------------------------------ params


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """Random init (scaled normal) in the stacked-layer layout, drawn
    from ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    L, H, M = cfg.num_layers, cfg.hidden, cfg.mlp_dim
    hd, nq, nkv = cfg.head_dim, cfg.heads, cfg.kv_heads
    dt = _dtype(cfg)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w / np.sqrt(fan_in)).to(dt)

    return {
        "tok_emb": dense((cfg.vocab_size, H), H),
        "attn_norm": torch.ones((L, H), dtype=dt, device=dev),
        "ffn_norm": torch.ones((L, H), dtype=dt, device=dev),
        "wq": dense((L, H, nq * hd), H),
        "wk": dense((L, H, nkv * hd), H),
        "wv": dense((L, H, nkv * hd), H),
        "wo": dense((L, nq * hd, H), nq * hd),
        "w_gate": dense((L, H, M), H),
        "w_up": dense((L, H, M), H),
        "w_down": dense((L, M, H), M),
        "final_norm": torch.ones((H,), dtype=dt, device=dev),
        "lm_head": dense((H, cfg.vocab_size), H),
    }


def convert_hf_llama_state_dict(state_dict: Dict[str, Any],
                                cfg: DecoderConfig,
                                device: DeviceLike = None) -> Dict[str, Any]:
    """`LlamaForCausalLM`-layout state dict (tensors or numpy arrays) ->
    stacked param tree. Linear weights are (out, in); ours are (in, out).
    Qwen2-family q/k/v projection biases are picked up when present, and
    a missing `lm_head.weight` means tied embeddings."""
    dev = resolve_device(device)
    dt = _dtype(cfg)

    def get(key: str) -> torch.Tensor:
        v = state_dict[key]
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().float()
        return torch.from_numpy(np.asarray(v, dtype=np.float32))

    def stacked(fmt: str, transpose: bool = True) -> torch.Tensor:
        mats = [get(fmt.format(i)) for i in range(cfg.num_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return torch.stack(mats).to(dt).to(dev)

    head_key = ("lm_head.weight" if "lm_head.weight" in state_dict
                else "model.embed_tokens.weight")
    out = {}
    for short, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                        ("bv", "v_proj")):
        if f"model.layers.0.self_attn.{proj}.bias" in state_dict:
            out[short] = stacked(
                "model.layers.{}.self_attn." + proj + ".bias",
                transpose=False)
    out.update({
        "tok_emb": get("model.embed_tokens.weight").to(dt).to(dev),
        "attn_norm": stacked(
            "model.layers.{}.input_layernorm.weight", transpose=False),
        "ffn_norm": stacked(
            "model.layers.{}.post_attention_layernorm.weight",
            transpose=False),
        "wq": stacked("model.layers.{}.self_attn.q_proj.weight"),
        "wk": stacked("model.layers.{}.self_attn.k_proj.weight"),
        "wv": stacked("model.layers.{}.self_attn.v_proj.weight"),
        "wo": stacked("model.layers.{}.self_attn.o_proj.weight"),
        "w_gate": stacked("model.layers.{}.mlp.gate_proj.weight"),
        "w_up": stacked("model.layers.{}.mlp.up_proj.weight"),
        "w_down": stacked("model.layers.{}.mlp.down_proj.weight"),
        "final_norm": get("model.norm.weight").to(dt).to(dev),
        "lm_head": get(head_key).T.contiguous().to(dt).to(dev),
    })
    return out


def quantize_decoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8: every matmul weight becomes ``{"q": int8, "s":
    f32}`` with one scale per OUTPUT channel (`tok_emb` per row, since
    it is gathered, not contracted). Norm vectors and biases stay."""
    out = {}
    for name, w in params.items():
        if name in ("attn_norm", "ffn_norm", "final_norm",
                    "bq", "bk", "bv"):
            out[name] = w
            continue
        wf = w.float()
        axis = -1 if name == "tok_emb" else -2  # contraction axis
        scale = torch.amax(wf.abs(), dim=axis, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        out[name] = {"q": q, "s": scale.squeeze(axis)}
    return out


def _mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain matrix or a quantized {"q","s"} pair; the scale
    is cast to x.dtype before it multiplies, as in the reference."""
    if isinstance(w, dict):
        y = x @ w["q"].to(x.dtype)
        return y * w["s"].to(x.dtype)
    return x @ w


def _take_emb(emb: Any, ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    ids = ids.long()
    if isinstance(emb, dict):
        rows = emb["q"][ids].to(dt)
        return rows * emb["s"][ids][..., None].to(dt)
    return emb[ids].to(dt)


def init_kv_cache(cfg: DecoderConfig, batch: int,
                  length: Optional[int] = None,
                  device: DeviceLike = None) -> Tuple[Any, Any]:
    """`length` sizes the slot axis (default cfg.max_len). With
    cfg.kv_quant each cache is ``{"q": int8, "s": f32 per (slot,
    kv-head)}`` instead of one cfg.dtype tensor."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, length or cfg.max_len,
             cfg.kv_heads, cfg.head_dim)

    def one():
        if cfg.kv_quant:
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev)}
        return torch.zeros(shape, dtype=_dtype(cfg), device=dev)

    return one(), one()


def _kv_quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., hd) -> int8 rows + one f32 scale per row (max-abs / 127)."""
    xf = x.float()
    s = torch.clamp(torch.amax(xf.abs(), dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def cache_len(cache: Any) -> int:
    """Slot-axis length of a cache in either representation."""
    return (cache["q"] if isinstance(cache, dict) else cache).shape[2]


# ----------------------------------------------------------------- forward


def _attn_kernel_ok(cfg: DecoderConfig, seq_len: int) -> bool:
    return _da.supported(seq_len=seq_len, kv_heads=cfg.kv_heads,
                         head_dim=cfg.head_dim)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def _rope(positions: torch.Tensor, cfg: DecoderConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (B, T, head_dim) in the HF rotate-half convention, with
    the HF `rope_scaling` schemes "linear" and "llama3"."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    if cfg.rope_kind == "linear":
        inv = inv / cfg.rope_factor
    elif cfg.rope_kind == "llama3":
        wavelen = (2.0 * np.pi) / inv
        low_wl = cfg.rope_original_max_len / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_len / cfg.rope_high_freq_factor
        smooth = (cfg.rope_original_max_len / wavelen
                  - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = (1.0 - smooth) * inv / cfg.rope_factor + smooth * inv
        inv = torch.where(wavelen < high_wl, inv,
                          torch.where(wavelen > low_wl,
                                      inv / cfg.rope_factor, scaled))
    elif cfg.rope_kind != "none":
        raise ValueError(f"unknown rope_kind {cfg.rope_kind!r}")
    freqs = positions.float()[..., None] * inv  # (B, T, hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    # x: (B, T, n_heads, head_dim); cos/sin: (B, T, head_dim)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rot * s


def _layer(p: Any, i: int) -> Any:
    return {k: v[i] for k, v in p.items()} if isinstance(p, dict) else p[i]


def _write(cache: Any, new: Any, i: int, start: int) -> None:
    """cache[i, :, start:start+T] = new, in place."""
    if isinstance(cache, dict):
        t = new["q"].shape[1]
        cache["q"][i, :, start:start + t] = new["q"]
        cache["s"][i, :, start:start + t] = new["s"]
    else:
        cache[i, :, start:start + new.shape[1]] = new


def forward(
    params: Dict[str, Any],
    cfg: DecoderConfig,
    ids: torch.Tensor,                 # (B, T) int
    positions: torch.Tensor,           # (B, T) int absolute positions
    cache_k: Any,                      # (L, B, S, KVH, hd) or {"q","s"}
    cache_v: Any,
    *,
    write_slot: Optional[int] = None,  # decode: SCALAR slot, all rows
    slot_positions: Optional[torch.Tensor] = None,  # (B, S) pos per slot
    lora: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Any, Any]:
    """One forward pass over T tokens against the cache.

    Prefill (write_slot=None): the T tokens are written at cache slots
    [0, T) — positions must be arange(T). Decode (write_slot given):
    every row's T tokens land at slots [write_slot, write_slot + T).
    Both write the caches in place and return them.

    Visibility: the query at absolute position p sees slot s iff
    slot_positions[b, s] <= p; the default is slot s holds position s.

    Returns (hidden (B, T, H), cache_k, cache_v)."""
    _no_lora(lora)
    B, T = ids.shape
    S = cache_len(cache_k)
    dt = _dtype(cfg)
    hd, kvh, G = cfg.head_dim, cfg.kv_heads, cfg.q_groups
    x = _take_emb(params["tok_emb"], ids, dt)
    cos, sin = _rope(positions, cfg)
    if slot_positions is None:
        slots = torch.arange(S, dtype=torch.int32,
                             device=ids.device)[None, None, :]
    else:
        slots = slot_positions[:, None, :]
    mask = slots <= positions[:, :, None]                  # (B, T, S)
    use_kernel = (cfg.kv_quant and cfg.attn_kernel and T == 1
                  and _attn_kernel_ok(cfg, S))
    start = 0 if write_slot is None else int(write_slot)

    def kv(c):
        return c["q"].to(dt) if cfg.kv_quant else c

    for i in range(cfg.num_layers):
        lp = {k: _layer(params[k], i) for k in
              ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
               "w_gate", "w_up", "w_down", "bq", "bk", "bv")
              if k in params}
        h = _rmsnorm(x, lp["attn_norm"], cfg.eps)
        q, k, v = _mm(h, lp["wq"]), _mm(h, lp["wk"]), _mm(h, lp["wv"])
        if "bq" in lp:  # Qwen2-family projection biases, pre-RoPE
            q = q + lp["bq"].to(q.dtype)
            k = k + lp["bk"].to(k.dtype)
            v = v + lp["bv"].to(v.dtype)
        q = _apply_rope(q.reshape(B, T, cfg.heads, hd), cos, sin)
        k = _apply_rope(k.reshape(B, T, kvh, hd), cos, sin)
        v = v.reshape(B, T, kvh, hd)
        if cfg.kv_quant:
            k, v = _kv_quantize(k), _kv_quantize(v)
        _write(cache_k, k, i, start)
        _write(cache_v, v, i, start)
        ck, cv = _layer(cache_k, i), _layer(cache_v, i)

        # grouped-query attention without materializing repeated K/V
        qg = q.reshape(B, T, kvh, G, hd)
        if use_kernel:
            out = _da.decode_attend_int8(qg.to(torch.bfloat16), ck, cv,
                                         mask[:, 0, :]).to(dt)
        else:
            # int8 caches: the per-slot scales commute past both
            # contractions — K scales multiply the scores, V scales the
            # probs — as in the reference
            scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                                  kv(ck).float())
            if cfg.kv_quant:
                scores.mul_(ck["s"].transpose(1, 2)[:, :, None, None, :])
            scores.div_(math.sqrt(hd))
            scores.masked_fill_(~mask[:, None, None, :, :], NEG)
            probs = torch.softmax(scores, dim=-1)
            del scores
            if cfg.kv_quant:
                probs.mul_(cv["s"].transpose(1, 2)[:, :, None, None, :])
            out = torch.einsum("bkgts,bskh->btkgh", probs.to(dt).float(),
                               kv(cv).float()).to(dt)
            del probs
        x = x + _mm(out.reshape(B, T, cfg.heads * hd), lp["wo"])
        h = _rmsnorm(x, lp["ffn_norm"], cfg.eps)
        x = x + _mm(F.silu(_mm(h, lp["w_gate"])) * _mm(h, lp["w_up"]),
                    lp["w_down"])
    return x, cache_k, cache_v


def _project(params: Dict[str, Any], cfg: DecoderConfig,
             hidden: torch.Tensor) -> torch.Tensor:
    """final RMSNorm + LM head -> f32 logits."""
    h = _rmsnorm(hidden, params["final_norm"], cfg.eps)
    return _mm(h, params["lm_head"]).float()


def prefill(params: Dict[str, Any], cfg: DecoderConfig, ids: torch.Tensor,
            prompt_len: torch.Tensor, cache_k: Any, cache_v: Any,
            lora: Optional[Dict[str, Any]] = None,
            ) -> Tuple[torch.Tensor, Any, Any]:
    """Run the prompt; return (last-token logits (B, V), cache, cache).

    `ids` is right-padded; `prompt_len` (B,) selects each row's final
    real token so only B rows hit the LM head (never (B, T, V))."""
    B, T = ids.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=ids.device)[None].expand(B, T)
    x, cache_k, cache_v = forward(params, cfg, ids, positions,
                                  cache_k, cache_v, lora=lora)
    rows = torch.arange(B, device=ids.device)
    last = x[rows, prompt_len.long() - 1]
    return _project(params, cfg, last), cache_k, cache_v


def decode_step(params: Dict[str, Any], cfg: DecoderConfig,
                token: torch.Tensor, pos: torch.Tensor, slot: int,
                cache_k: Any, cache_v: Any,
                slot_positions: Optional[torch.Tensor] = None,
                lora: Optional[Dict[str, Any]] = None,
                ) -> Tuple[torch.Tensor, Any, Any]:
    """One token per row at per-row position `pos` (B,), written at the
    shared scalar cache `slot`. Returns (logits (B, V), cache, cache)."""
    x, cache_k, cache_v = forward(
        params, cfg, token[:, None], pos[:, None], cache_k, cache_v,
        write_slot=slot, slot_positions=slot_positions, lora=lora)
    return _project(params, cfg, x[:, 0]), cache_k, cache_v


@torch.no_grad()
def score_continuations(params: Dict[str, Any], cfg: DecoderConfig,
                        ids: torch.Tensor, prompt_len: torch.Tensor,
                        total_len: torch.Tensor) -> torch.Tensor:
    """Exact log P(continuation | prompt) for C candidates in ONE
    teacher-forced forward. ids (C, T): each row = the SAME prompt
    followed by one candidate, right-padded; prompt_len/total_len (C,)
    delimit the scored span. Returns (C,) summed token log-probs."""
    dev = _params_device(params)
    ids = _as_tensor(ids, torch.int32, dev)
    prompt_len = _as_tensor(prompt_len, torch.int32, dev)
    total_len = _as_tensor(total_len, torch.int32, dev)
    C, T = ids.shape
    z1, z2 = init_kv_cache(cfg, C, T, device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        C, T)
    x, _, _ = forward(params, cfg, ids, positions, z1, z2)
    lp = torch.log_softmax(_project(params, cfg, x)[:, :-1], dim=-1)
    tok_lp = torch.gather(lp, -1, ids[:, 1:, None].long())[..., 0]
    j = torch.arange(T - 1, dtype=torch.int32, device=dev)[None, :]
    m = ((j >= prompt_len[:, None] - 1)
         & (j < total_len[:, None] - 1)).to(tok_lp.dtype)
    return torch.sum(tok_lp * m, dim=1)


# ---------------------------------------------------------------- sampling


def topk_logits(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling candidate set: exact top-k (values, indices), sorted
    descending. (The reference takes `approx_max_k` for vocabularies of
    4096 or more on the TPU; off the TPU that is exact top-k.)"""
    k = min(top_k, logits.shape[-1])
    return torch.topk(logits, k, dim=-1, sorted=True)


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator], *,
                  temperature: float, top_k: int, top_p: float
                  ) -> torch.Tensor:
    """Temperature -> top-k -> nucleus within the top-k -> categorical
    (Gumbel-max, as `jax.random.categorical`). temperature == 0 is
    argmax, which keeps the first maximum."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = topk_logits(logits / temperature, top_k)  # sorted desc
    if top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = (csum - probs) < top_p  # first token always kept
        vals = torch.where(keep, vals, -torch.inf)
    u = torch.rand(vals.shape, generator=generator, dtype=torch.float32,
                   device=vals.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    choice = torch.argmax(vals - torch.log(-torch.log(u)), dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)


# -------------------------------------------------------------- generation


@torch.no_grad()
def generate_logprobs(params: Dict[str, Any], cfg: DecoderConfig,
                      ids, prompt_len, max_new: int,
                      eos_id: int, pad_id: int,
                      rng: Optional[torch.Generator] = None,
                      temperature: float = 0.0, top_k: int = 64,
                      top_p: float = 1.0,
                      lora: Optional[Dict[str, Any]] = None,
                      presence: float = 0.0, frequency: float = 0.0,
                      constraint: Optional[Dict[str, Any]] = None,
                      logit_bias=None,  # (V,) f32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch generation: prefill + a decode loop. Returns (tokens
    (B, max_new) int32 — pad_id after each row's eos — n_generated (B,),
    and each emitted token's RAW model log-probability (log-softmax of
    the unscaled logits; 0.0 at pad positions)).

    ``ids``/``prompt_len`` are right-padded prompts and their lengths
    (numpy or tensors); ``rng`` is the generator sampled draws come from
    (unused when greedy). Presence/frequency penalties and `logit_bias`
    shape sampling only, as in the reference."""
    _no_lora(lora)
    if constraint is not None:
        raise NotImplementedError(
            "grammar constraints are not ported yet (models/constrain.py)")
    dev = _params_device(params)
    ids = _as_tensor(ids, torch.int32, dev)
    prompt_len = _as_tensor(prompt_len, torch.int32, dev)
    if rng is None and temperature != 0.0:
        rng = torch.Generator(device=dev).manual_seed(0)
    B, T = ids.shape
    V = cfg.vocab_size
    # cache sized to this request: prompt slots [0, T) + one slot per
    # decode step; generated tokens live at slot T + step for EVERY row.
    S = T + max_new
    if cfg.kv_quant and cfg.attn_kernel and _da.pick_block(S) is None:
        # round the slot axis up so the fused decode kernel tiles it; the
        # extra slots carry slot_pos > every query position
        S = -(-S // 256) * 256
    cache_k, cache_v = init_kv_cache(cfg, B, S, device=dev)
    s_idx = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    pl = prompt_len[:, None]
    slot_pos = torch.where(
        s_idx < T,
        torch.where(s_idx < pl, s_idx, torch.full_like(s_idx, 2 ** 30)),
        pl + (s_idx - T)).to(torch.int32)
    logits, cache_k, cache_v = prefill(params, cfg, ids, prompt_len,
                                       cache_k, cache_v)

    penalize = presence != 0.0 or frequency != 0.0
    rows_b = torch.arange(B, device=dev)
    counts = None
    if penalize:
        in_prompt = (torch.arange(T, device=dev)[None, :]
                     < prompt_len[:, None]).to(torch.int32)
        counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, ids.long(), in_prompt)
    bias = (None if logit_bias is None
            else _as_tensor(logit_bias, torch.float32, dev))
    pad = torch.tensor(pad_id, dtype=torch.int32, device=dev)

    def emit(logits, done):
        sample_from = logits
        if bias is not None:
            sample_from = sample_from + bias[None, :]
        if penalize:
            sample_from = (sample_from
                           - presence * (counts > 0).to(logits.dtype)
                           - frequency * counts.to(logits.dtype))
        tok = sample_logits(sample_from, rng, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                          tok[:, None].long())[:, 0]
        return (torch.where(done, pad, tok),
                torch.where(done, torch.zeros_like(lp), lp))

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok, tok_lp = emit(logits, done)
    out = torch.full((max_new, B), pad_id, dtype=torch.int32, device=dev)
    lps = torch.zeros((max_new, B), dtype=torch.float32, device=dev)
    pos = prompt_len.clone()
    for step in range(max_new):
        if step and step % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        out[step] = tok
        lps[step] = tok_lp
        newly_done = done | (tok == eos_id)
        if penalize:  # the consumed token joins "the text so far"
            counts.index_put_((rows_b, tok.long()),
                              (~newly_done).to(torch.int32), accumulate=True)
        logits, cache_k, cache_v = decode_step(
            params, cfg, tok, pos, T + step, cache_k, cache_v,
            slot_positions=slot_pos)
        # rows that just emitted eos stop: their buffered token is pad
        tok, tok_lp = emit(logits, newly_done)
        pos = torch.where(newly_done, pos, pos + 1)
        done = newly_done
    out = out.T  # (B, max_new)
    lps = torch.where(out != pad_id, lps.T, 0.0)
    return out, (out != pad_id).sum(dim=1).to(torch.int32), lps


def generate(params: Dict[str, Any], cfg: DecoderConfig,
             ids, prompt_len, max_new: int, eos_id: int, pad_id: int,
             rng: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 64,
             top_p: float = 1.0,
             lora: Optional[Dict[str, Any]] = None,
             presence: float = 0.0, frequency: float = 0.0,
             constraint: Optional[Dict[str, Any]] = None,
             logit_bias=None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`generate_logprobs` without the log-probs: returns (tokens
    (B, max_new) int32 — pad_id after each row's eos — n_generated)."""
    out, n, _ = generate_logprobs(params, cfg, ids, prompt_len, max_new,
                                  eos_id, pad_id, rng, temperature,
                                  top_k, top_p, lora, presence, frequency,
                                  constraint, logit_bias)
    return out, n


def make_decode_step(params: Dict[str, Any], cfg: DecoderConfig):
    """Single-token step for streaming (`LocalLLM.stream`). Unpadded rows
    only (slot == position, true for the B = 1 streaming path), so the
    default slot layout applies."""
    dev = _params_device(params)

    @torch.no_grad()
    def _step(token, pos, cache_k, cache_v, rng,
              temperature: float, top_k: int, top_p: float):
        slot = int(pos[0])
        token = _as_tensor(token, torch.int32, dev)
        pos = _as_tensor(pos, torch.int32, dev)
        logits, cache_k, cache_v = decode_step(
            params, cfg, token, pos, slot, cache_k, cache_v)
        nxt = sample_logits(logits, rng, temperature=temperature,
                            top_k=top_k, top_p=top_p)
        return nxt, cache_k, cache_v

    return _step
