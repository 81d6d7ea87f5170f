"""Plain reference of a Mistral-style decoder (Mistral-7B-Instruct-v0.2's
architecture): RMSNorm, grouped-query attention with rotate-half RoPE,
a SiLU-gated MLP, an untied output head, no sliding window.

Plain PyTorch in float32 with TF32 off, one full causal forward over a
whole sequence, no cache and no batching, one layer's weights at a time.
It imports nothing of the program. The weights are drawn again from the
seed (benchmark/data.py) and quantized here as the configuration states:
int8 with one scale per output channel (per row of the embedding), the
scale max|w| / 127, round half to even. ``bits=4`` quantizes to int4
instead (max|w| / 7): the control one step below the configuration.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .. import data
from .search import no_tf32


class Weights:
    """Every weight of the seed's model, quantized, kept as int codes
    plus scales until a layer needs them."""

    def __init__(self, seed: int, cfg: Dict, device, bits: int = 8):
        self.cfg, self.bits = cfg, bits
        self.leaves = {}
        for name in data.DECODER_LEAVES:
            w = data.decoder_leaf(seed, cfg, name, device)
            # the contracted axis: rows of the embedding are gathered
            axis = -1 if name == "tok_emb" else -2
            self.leaves[name] = _Packed(w, axis, bits)
            del w

    def get(self, name: str, layer: int = -1) -> torch.Tensor:
        return self.leaves[name].f32(layer)


class _Packed:
    """A leaf as int8 codes (int4 values fit) and f32 scales."""

    def __init__(self, w: torch.Tensor, axis: int, bits: int):
        qmax = float(2 ** (bits - 1) - 1)
        # max|w| is exact in bf16, so it is taken before the upcast
        self.scale = torch.clamp(
            torch.amax(w.abs(), dim=axis, keepdim=True).float() / qmax,
            min=1e-12)
        self.codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        # one layer at a time keeps the float copy small
        lead = range(w.shape[0]) if w.dim() == 3 else [None]
        for i in lead:
            wi = w.float() if i is None else w[i].float()
            si = self.scale if i is None else self.scale[i]
            q = torch.clamp(torch.round(wi / si), -qmax, qmax)
            if i is None:
                self.codes.copy_(q)
            else:
                self.codes[i].copy_(q)

    def f32(self, layer: int) -> torch.Tensor:
        if layer < 0:
            return self.codes.float() * self.scale
        return self.codes[layer].float() * self.scale[layer]


def _rmsnorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    # every norm weight of the random model is 1
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of (T, heads, hd) at positions 0 .. T-1."""
    t, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


@torch.no_grad()
def logits(weights: Weights, ids: Sequence[int], first: int) -> torch.Tensor:
    """f32 logits of positions ``first`` .. len(ids) - 1 of one sequence:
    row j predicts the token after position first + j."""
    cfg = weights.cfg
    nq, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    emb = weights.leaves["tok_emb"]
    tok = torch.as_tensor(list(ids), device=emb.codes.device).long()
    t = tok.shape[0]
    with no_tf32():
        x = emb.codes[tok].float() * emb.scale[tok]
        causal = torch.ones(t, t, dtype=torch.bool,
                            device=x.device).tril()
        for i in range(cfg["num_hidden_layers"]):
            h = _rmsnorm(x, eps)
            q = _rope((h @ weights.get("wq", i)).view(t, nq, hd), theta)
            k = _rope((h @ weights.get("wk", i)).view(t, nkv, hd), theta)
            v = (h @ weights.get("wv", i)).view(t, nkv, hd)
            rep = nq // nkv
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
            out = torch.empty_like(q)
            for hh in range(nq):  # one head at a time: (T, T) scores
                s = (q[:, hh] @ k[:, hh].T) / hd ** 0.5
                s = s.masked_fill(~causal, float("-inf"))
                out[:, hh] = torch.softmax(s, dim=-1) @ v[:, hh]
            x = x + out.reshape(t, nq * hd) @ weights.get("wo", i)
            h = _rmsnorm(x, eps)
            g = h @ weights.get("w_gate", i)
            u = h @ weights.get("w_up", i)
            x = x + (torch.nn.functional.silu(g) * u) @ weights.get(
                "w_down", i)
        h = _rmsnorm(x[first:], eps)
        return h @ weights.get("lm_head")


def served_gaps(ref: Weights, prompt: List[int], served: List[int],
                other: Weights = None) -> torch.Tensor:
    """Per served token, how far its reference logit lies below the
    reference's best at that position. With ``other``, the token judged
    at each position is the one ``other`` puts first there instead of
    the served one (the control, read without decoding)."""
    seq = list(prompt) + list(served)
    first = len(prompt) - 1
    lr = logits(ref, seq[:-1], first)
    if other is None:
        picked = torch.as_tensor(served, device=lr.device).long()
    else:
        picked = logits(other, seq[:-1], first).argmax(-1)
    return lr.max(-1).values - lr.gather(-1, picked[:, None])[:, 0]
