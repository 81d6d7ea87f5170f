"""Plain reference of DeepSeek-V2 (DeepSeek-V2-Lite's architecture,
`modeling_deepseek.py` beside its config, arXiv:2405.04434): RMSNorm,
multi-head latent attention with YaRN RoPE, a dense SwiGLU MLP in the
first `first_k_dense_replace` layers and, in the others, 2 shared + 64
routed SwiGLU experts under a softmax top-6 router; an untied head.

Plain PyTorch in float32 with TF32 off, one full causal forward over
whole sequences, no cache and no batching: the latents are expanded to
K and V for every position, and the routed experts run as a loop over
the experts, each on the tokens that chose it. Layers run one at a time
over every sequence given, each layer's weights drawn from the seed just
before its use and dropped after it. It imports nothing of the program.

The weights are drawn from the seed (`draw`: N(0, 1/fan_in), bf16, on
the given device, one call a leaf and layer; the driver draws the same
ones for the program) and quantized here as the configuration states:
int8 with one scale per output channel (per row of the embedding), the
scale max|w| / 127, round half to even; the router stays in bf16 and
every norm weight is 1. ``bits=4`` quantizes to int4 instead (max|w| /
7): the control one step below the configuration.

Departures from `modeling_deepseek.py`, none of which changes the
function: float32 throughout (the module runs in the checkpoint's
bf16); no KV cache and no attention or expert kernels; the experts'
outputs are added expert by expert where the module gathers them per
token (`moe_infer`); a weight is (in, out) where an `nn.Linear` holds
(out, in); the YaRN cos/sin tables are computed at each sequence's
positions instead of cached; `kv_b_proj` is one (kv_lora_rank, heads x
(nope + v)) matrix, a head's nope columns then its v columns, as the
module views it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import data
from .search import no_tf32

# each leaf's draw stream: tag 300 + 100 * index + layer
LEAVES = ("embed", "q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj",
          "gate_proj", "up_proj", "down_proj", "gate", "experts.gate_proj",
          "experts.up_proj", "experts.down_proj", "shared.gate_proj",
          "shared.up_proj", "shared.down_proj", "lm_head")
KVA_EPS = 1e-6  # kv_a_layernorm is a DeepseekV2RMSNorm at its default eps


def leaf_shapes(cfg: Dict, layer: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                          int]]:
    """The leaves of layer ``layer`` (-1: embedding and head) in the (in,
    out) layout, with their fan-in."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    if layer < 0:
        return {"embed": ((V, H), H), "lm_head": ((H, V), H)}
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    out = {"q_proj": ((H, nh * (dn + dr)), H),
           "kv_a_proj_with_mqa": ((H, r + dr), H),
           "kv_b_proj": ((r, nh * (dn + dv)), r),
           "o_proj": ((nh * dv, H), nh * dv)}
    if layer < cfg["first_k_dense_replace"]:
        M = cfg["intermediate_size"]
        out.update({"gate_proj": ((H, M), H), "up_proj": ((H, M), H),
                    "down_proj": ((M, H), M)})
    else:
        E, Fw = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        Fs = cfg["n_shared_experts"] * Fw
        out.update({"gate": ((H, E), H),
                    "experts.gate_proj": ((E, H, Fw), H),
                    "experts.up_proj": ((E, H, Fw), H),
                    "experts.down_proj": ((E, Fw, H), Fw)})
        if Fs:
            out.update({"shared.gate_proj": ((H, Fs), H),
                        "shared.up_proj": ((H, Fs), H),
                        "shared.down_proj": ((Fs, H), Fs)})
    return out


def draw(seed: int, cfg: Dict, name: str, layer: int,
         device) -> torch.Tensor:
    """One random bf16 leaf of one layer (-1 for the embedding and the
    head), N(0, 1/fan_in), in one call on ``device``; the same seed
    gives the same leaf."""
    shape, fan_in = leaf_shapes(cfg, layer)[name]
    tag = 300 + 100 * LEAVES.index(name) + max(layer, 0)
    w = torch.randn(shape, generator=data.torch_gen(seed, tag, device),
                    device=device, dtype=torch.bfloat16)
    return w.mul_(1.0 / math.sqrt(fan_in))


def quantized(w: torch.Tensor, axis: int, bits: int) -> torch.Tensor:
    """w quantized to ``bits`` with one scale per channel along the axes
    other than ``axis`` (the contracted one), back in f32."""
    qmax = float(2 ** (bits - 1) - 1)
    # max|w| is exact in bf16, so it is taken before the upcast
    scale = torch.clamp(torch.amax(w.abs(), dim=axis, keepdim=True).float()
                        / qmax, min=1e-12)
    return torch.clamp(torch.round(w.float() / scale), -qmax, qmax) * scale


class Weights:
    """The seed's model, drawn and quantized a layer at a time."""

    def __init__(self, seed: int, cfg: Dict, device, bits: int = 8):
        self.seed, self.cfg, self.device, self.bits = seed, cfg, device, bits

    def layer(self, layer: int) -> Dict[str, torch.Tensor]:
        out = {}
        for name in leaf_shapes(self.cfg, layer):
            w = draw(self.seed, self.cfg, name, layer, self.device)
            if name == "gate":  # the router stays in bf16
                out[name] = w.float()
            else:
                out[name] = quantized(w, -1 if name == "embed" else -2,
                                      self.bits)
            del w
        return out


def _rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    # every norm weight of the random model is 1
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(cfg: Dict) -> torch.Tensor:
    """`DeepseekV2YarnRotaryEmbedding`'s inverse frequencies (float64)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg.get("rope_scaling")
    pos = torch.arange(0, dim, 2, dtype=torch.float64) / dim
    extra = 1.0 / base ** pos
    if not rs:
        return extra
    factor = float(rs["factor"])
    inter = 1.0 / (factor * base ** pos)
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cfg: Dict) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = _mscale(float(rs["factor"]), rs["mscale_all_dim"])
        s = s * m * m
    return s


def _rope(x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(T, heads, d) at positions 0 .. T-1: adjacent pairs permuted to
    rotate-half order, then rotated (`apply_rotary_pos_emb`)."""
    t, nh, d = x.shape
    rs = cfg.get("rope_scaling")
    m = 1.0
    if rs:
        m = _mscale(float(rs["factor"]), rs["mscale"]) / _mscale(
            float(rs["factor"]), rs["mscale_all_dim"])
    ang = torch.arange(t, dtype=torch.float64)[:, None] * inv_freq(cfg)
    ang = torch.cat([ang, ang], dim=-1).to(x.device)
    cos = (torch.cos(ang) * m).float()[:, None]
    sin = (torch.sin(ang) * m).float()[:, None]
    x = x.reshape(t, nh, d // 2, 2).transpose(-1, -2).reshape(t, nh, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _swiglu(h, gate, up, down):
    return (F.silu(h @ gate) * (h @ up)) @ down


def route(cfg: Dict, h: torch.Tensor, gate: torch.Tensor):
    """Softmax top-k over the router's logits (greedy): (weights, ids)."""
    probs = torch.softmax(h @ gate, dim=-1)
    w, ids = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"], ids


def _experts(cfg: Dict, lw: Dict, h: torch.Tensor) -> torch.Tensor:
    w, ids = route(cfg, h, lw["gate"])
    y = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], lw["experts.gate_proj"][e],
                          lw["experts.up_proj"][e],
                          lw["experts.down_proj"][e])
            y.index_add_(0, rows, out * w[rows, slot][:, None])
    if "shared.gate_proj" in lw:
        y = y + _swiglu(h, lw["shared.gate_proj"], lw["shared.up_proj"],
                        lw["shared.down_proj"])
    return y


def _attention(cfg: Dict, lw: Dict, h: torch.Tensor) -> torch.Tensor:
    t = h.shape[0]
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    q = (h @ lw["q_proj"]).view(t, nh, -1)
    kva = h @ lw["kv_a_proj_with_mqa"]
    c = _rmsnorm(kva[:, :r], KVA_EPS)
    k_pe = _rope(kva[:, None, r:], cfg)[:, 0]
    q_pe = _rope(q[..., dn:], cfg)
    kv = (c @ lw["kv_b_proj"]).view(t, nh, dn + dv)
    scale = softmax_scale(cfg)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(t, nh, dv, device=h.device)
    for hh in range(nh):  # one head at a time: (T, T) scores
        s = (q[:, hh, :dn] @ kv[:, hh, :dn].T + q_pe[:, hh] @ k_pe.T) * scale
        s = s.masked_fill(~causal, float("-inf"))
        out[:, hh] = torch.softmax(s, dim=-1) @ kv[:, hh, dn:]
    return out.reshape(t, nh * dv) @ lw["o_proj"]


@torch.no_grad()
def logits_many(weights: Weights, seqs: Sequence[Sequence[int]],
                firsts: Sequence[int]) -> List[torch.Tensor]:
    """f32 logits of positions first .. len(ids) - 1 of each sequence:
    row j predicts the token after position first + j."""
    cfg = weights.cfg
    eps = cfg["rms_norm_eps"]
    with no_tf32():
        head = weights.layer(-1)
        xs = [head["embed"][torch.as_tensor(list(s), device=weights.device)
                            .long()] for s in seqs]
        lm_head = head["lm_head"]
        del head
        for i in range(cfg["num_hidden_layers"]):
            lw = weights.layer(i)
            for j, x in enumerate(xs):
                x = x + _attention(cfg, lw, _rmsnorm(x, eps))
                h = _rmsnorm(x, eps)
                if i < cfg["first_k_dense_replace"]:
                    x = x + _swiglu(h, lw["gate_proj"], lw["up_proj"],
                                    lw["down_proj"])
                else:
                    x = x + _experts(cfg, lw, h)
                xs[j] = x
            del lw
        return [_rmsnorm(x[f:], eps) @ lm_head for x, f in zip(xs, firsts)]


def logits(weights: Weights, ids: Sequence[int], first: int) -> torch.Tensor:
    return logits_many(weights, [ids], [first])[0]


def served_gaps_many(ref: Weights, samples: Sequence[Tuple[List[int],
                                                           List[int]]],
                     other: Weights = None) -> List[torch.Tensor]:
    """For each (prompt, served) pair: per served token, how far its
    reference logit lies below the reference's best at that position.
    With ``other``, the token judged at each position is the one
    ``other`` puts first there instead of the served one (the control,
    read without decoding)."""
    seqs = [list(p) + list(s) for p, s in samples]
    firsts = [len(p) - 1 for p, _ in samples]
    lrs = logits_many(ref, [q[:-1] for q in seqs], firsts)
    if other is None:
        picked = [torch.as_tensor(s, device=lr.device).long()
                  for (_, s), lr in zip(samples, lrs)]
    else:
        picked = [lo.argmax(-1) for lo in logits_many(
            other, [q[:-1] for q in seqs], firsts)]
    return [lr.max(-1).values - lr.gather(-1, p[:, None])[:, 0]
            for lr, p in zip(lrs, picked)]
