"""Multi-head latent attention (MLA) with YaRN RoPE: DeepSeek-V2's
attention, as `modeling_deepseek.py` writes it (``q_lora_rank`` null),
for the decoder's latent layers (models/decoder.py::forward).

Per layer, with h the normed hidden state:

    q = h W_q, viewed (heads, nope + rope): q_nope, q_pe
    [c, k_pe] = h W_kva                      (kv_lora_rank + rope wide)
    c = RMSNorm(c) * kva_norm                (eps 1e-6, the module's own)
    q_pe, k_pe = RoPE(q_pe), RoPE(k_pe)      (k_pe one head, shared)
    k_h = [c W_uk_h, k_pe], v_h = c W_uv_h   (W_kvb = [W_uk | W_uv] a head)
    o_h = softmax(q_h . k_h * scale) v_h,  out = [o_h] W_o

The cache holds one latent a slot, ``[c, k_pe]`` (576 values at
DeepSeek-V2-Lite's widths), one kv head: (L, B, S, 1, latent), or with
`kv_quant` int8 codes with ONE f32 scale a slot (max|.| / 127 over all
576 values, as `_kv_quantize` does a row): the decode kernel takes one
scale per (slot, kv head), and c (RMSNorm'd, ~unit RMS) and k_pe (a
projection of a normed state) are of one magnitude, so a second scale
would buy little precision and cost a kernel change.

Two ways to attend, equal in exact arithmetic:

  * `expanded` (prefill, T > 1): every visible slot's latent is expanded
    to K and V by W_uk and W_uv, then MHA (qk nope + rope, v wide);
  * `absorbed` (decode, T = 1): W_uk folds into the query (q_lat_h =
    q_nope_h W_uk_h^T, kv_lora_rank wide), the scores are q_lat . c +
    q_pe . k_pe over the latents themselves, and W_uv maps the weighted
    latent back: o_h = (sum_s p_s c_s) W_uv_h. That is MQA with G =
    heads and hd = latent, which the int8 decode kernel runs
    (ops/decode_attn.py) with the latent as key and its first
    kv_lora_rank values as value.

The scales of an int8 cache commute past both contractions (a slot's
scale multiplies its scores and its probabilities), as in the dense
decoder's einsum path.

RoPE follows DeepSeek's pairing: `modeling_deepseek.apply_rotary_pos_emb`
views the rope dims as adjacent pairs (2i, 2i+1) and permutes them to
rotate-half order before rotating, so the checkpoint's W_q and W_kva
columns load as they are; the cache keeps k_pe in the permuted order,
which q_pe shares. YaRN frequencies follow
`DeepseekV2YarnRotaryEmbedding`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..ops import decode_attn as _da
from .decoder import NEG, DecoderConfig, _mm_one

KVA_EPS = 1e-6  # DeepseekV2RMSNorm's default, which kv_a_layernorm takes


# -------------------------------------------------------------------- rope


def yarn_mscale(scale: float, mscale: float) -> float:
    """`yarn_get_mscale`: 0.1 * mscale * ln(scale) + 1 (1 at scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DecoderConfig, dim: int) -> Tuple[int, int]:
    """`yarn_find_correction_range`: the rope dims between the rotations
    ``beta_fast`` and ``beta_slow`` over the original context."""
    def at(rot: float) -> float:
        return (dim * math.log(cfg.rope_original_max_len
                               / (rot * 2 * math.pi))) / (
            2 * math.log(cfg.rope_theta))
    low = math.floor(at(cfg.rope_beta_fast))
    high = math.ceil(at(cfg.rope_beta_slow))
    return max(low, 0), min(high, dim - 1)


def inv_freq(cfg: DecoderConfig) -> torch.Tensor:
    """The rope dims' inverse frequencies (f32, dim / 2): plain, or YaRN's
    linear ramp from inv_freq / factor (long wavelengths) to inv_freq
    (short ones)."""
    dim = cfg.qk_rope_head_dim
    base = cfg.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                              / dim)
    extra = 1.0 / base
    if cfg.rope_kind == "none":
        return extra
    if cfg.rope_kind != "yarn":
        raise ValueError(f"latent attention takes rope_kind 'none' or "
                         f"'yarn', not {cfg.rope_kind!r}")
    inter = 1.0 / (cfg.rope_factor * base)
    low, high = yarn_correction_range(cfg, dim)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp  # 1: extrapolate (inv_freq), 0: interpolate
    return inter * (1 - keep) + extra * keep


def cos_sin_factor(cfg: DecoderConfig) -> float:
    """YaRN's factor on cos and sin: mscale(factor, mscale) over
    mscale(factor, mscale_all_dim) (1 for DeepSeek-V2-Lite)."""
    if cfg.rope_kind != "yarn":
        return 1.0
    return (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
            / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))


def softmax_scale(cfg: DecoderConfig) -> float:
    """qk_head_dim^-0.5, times mscale(factor, mscale_all_dim)^2 under
    YaRN (`DeepseekV2Attention.softmax_scale`)."""
    s = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.rope_kind == "yarn" and cfg.rope_mscale_all_dim:
        m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
        s = s * m * m
    return s


_INV: Dict[Tuple[DecoderConfig, torch.device], torch.Tensor] = {}


def inv_freq_on(cfg: DecoderConfig, device: torch.device) -> torch.Tensor:
    """`inv_freq` on ``device``, copied there once: a forward makes no
    copy from the host, which would wait on the card."""
    key = (cfg, device)
    t = _INV.get(key)
    if t is None:
        t = _INV.setdefault(key, inv_freq(cfg).to(device))
    return t


def rope_tables(positions: torch.Tensor, cfg: DecoderConfig,
                inv: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (B, T, rope dim) in rotate-half order for ``positions``,
    taken in f32 and cast to ``dtype`` (the activations'), once a
    forward."""
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    f = cos_sin_factor(cfg)
    cos, sin = torch.cos(emb), torch.sin(emb)
    if f != 1.0:
        cos, sin = cos * f, sin * f
    return cos.to(dtype), sin.to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's RoPE of x (B, T, heads, d): the adjacent pairs permuted
    to rotate-half order (x0, x2, ..., x1, x3, ...), then rotated; cos and
    sin cast to x's type."""
    B, T, nh, d = x.shape
    x = x.reshape(B, T, nh, d // 2, 2).transpose(-1, -2).reshape(B, T, nh, d)
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rot * s


# --------------------------------------------------------------- attention


def _latents(lat: Any) -> Tuple[torch.Tensor, Any]:
    """A layer's cache (B, S, 1, latent) as (values, per-slot scale or
    None): int8 codes and (B, S) f32 scales, or the float latents."""
    if isinstance(lat, dict):
        return lat["q"][:, :, 0], lat["s"][:, :, 0]
    return lat[:, :, 0], None


def _per_head(w: Any, heads: int) -> Tuple[torch.Tensor, Any]:
    """W_uk or W_uv (r, heads * d) as (r, heads, d) values and the (heads,
    d) output-channel scales (None for a float weight)."""
    if isinstance(w, dict):
        q = w["q"]
        return q.view(q.shape[0], heads, -1), w["s"].view(heads, -1)
    return w.view(w.shape[0], heads, -1), None


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (3-D) with f32 sums and an f32 result: on the card one
    tensor-core product of the bf16 operands (`out_dtype`; the products of
    bf16 values are exact in f32, as in f32 operands), else the product
    of f32 copies."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def expanded(q_nope: torch.Tensor, q_pe: torch.Tensor, lat: Any,
             w_uk: Any, w_uv: Any, mask: torch.Tensor, scale: float,
             rank: int) -> torch.Tensor:
    """MHA over the latents expanded to K and V: q_nope (B, T, nh, dn),
    q_pe (B, T, nh, dr), mask (B, T, S) -> (B, T, nh, dv) in q's type.
    Scores and softmax in f32 (the products over operands in q's type,
    summed in f32); an int8 cache's codes are expanded as they are and
    each slot's scale multiplies its scores (with the softmax scale) and
    its probabilities."""
    dt = q_nope.dtype
    B, T, nh, _ = q_nope.shape
    vals, s = _latents(lat)
    c = vals[..., :rank].to(dt)
    S = c.shape[1]
    k_nope = _mm_one(c, w_uk).view(B, S, nh, -1)
    pe = vals[..., None, rank:].to(dt).expand(B, S, nh, -1)
    k = torch.cat([k_nope, pe], dim=-1).permute(0, 2, 3, 1)  # (B,nh,d,S)
    del k_nope, pe
    q = torch.cat([q_nope, q_pe.to(dt)], dim=-1).transpose(1, 2)
    scores = _bmm_f32(q.reshape(B * nh, T, -1),
                      k.reshape(B * nh, -1, S)).view(B, nh, T, S)
    del k
    if s is not None:
        scores.mul_((s * scale)[:, None, None, :])
    else:
        scores.mul_(scale)
    scores.masked_fill_(~mask[:, None], NEG)
    probs = torch.softmax(scores, dim=-1)
    del scores
    if s is not None:
        probs.mul_(s[:, None, None, :])
    v = _mm_one(c, w_uv).view(B, S, nh, -1).transpose(1, 2)
    out = _bmm_f32(probs.to(dt).view(B * nh, T, S),
                   v.reshape(B * nh, S, -1))
    return out.view(B, nh, T, -1).transpose(1, 2).to(dt)


def absorb_query(q_nope: torch.Tensor, w_uk: Any, heads: int
                 ) -> torch.Tensor:
    """q_lat_h = q_nope_h W_uk_h^T: (B, T, nh, dn) -> (B, T, nh, r); an
    int8 W_uk's scales (on the contracted dn) multiply q first."""
    wq, ws = _per_head(w_uk, heads)
    dt = q_nope.dtype
    if ws is not None:
        q_nope = q_nope * ws.to(dt)
    return torch.einsum("bthd,chd->bthc", q_nope, wq.to(dt))


def absorbed(q_nope: torch.Tensor, q_pe: torch.Tensor, lat: Any,
             w_uk: Any, w_uv: Any, mask: torch.Tensor, scale: float,
             rank: int, kernel: bool) -> torch.Tensor:
    """MQA over the latents with W_uk and W_uv absorbed: the same
    contract as `expanded`. ``kernel`` (T = 1, int8 cache): the scores,
    softmax and weighted latent go through `decode_attend_int8`, the
    cache passed as key and as value; else an einsum path with the
    kernel's rounding points (q in the activation type, scores and
    softmax f32, p * scale rounded before the value product)."""
    dt = q_nope.dtype
    B, T, nh, _ = q_nope.shape
    q = torch.cat([absorb_query(q_nope, w_uk, nh), q_pe.to(dt)], dim=-1)
    if kernel:
        qg = q.to(torch.bfloat16).reshape(B, 1, 1, nh, -1)
        o = _da.decode_attend_int8(qg, lat, lat, mask[:, 0, :], scale)
        o = o.reshape(B, 1, nh, -1)[..., :rank].to(dt)
    else:
        vals, s = _latents(lat)
        scores = torch.einsum("bthc,bsc->bhts", q.float(), vals.to(dt).float())
        if s is not None:
            scores.mul_(s[:, None, None, :])
        scores.mul_(scale)
        scores.masked_fill_(~mask[:, None], NEG)
        probs = torch.softmax(scores, dim=-1)
        del scores
        if s is not None:
            probs.mul_(s[:, None, None, :])
        o = torch.einsum("bhts,bsc->bthc", probs.to(dt).float(),
                         vals[..., :rank].to(dt).float()).to(dt)
    wv, vs = _per_head(w_uv, nh)
    out = torch.einsum("bthc,chd->bthd", o, wv.to(dt))
    return out if vs is None else out * vs.to(dt)
