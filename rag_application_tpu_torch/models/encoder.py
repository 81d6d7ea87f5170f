"""The text encoder (768-d, v1 parity) as a PyTorch module.

Port of `rag_application_tpu/models/encoder.py` (`TransformerLayer`,
`TextEncoder`, `EncoderState`, `init_encoder`): a pre-LN transformer
encoder, mean-pooled over the attention mask and L2-normalized. The flax
modules' numerics are kept where they differ from PyTorch's habits:

  * parameters stay float32 and are cast to the compute dtype at use
    (`nn.Embed`/`nn.Dense` with ``dtype=bf16``); a dense layer rounds its
    product to the compute dtype before adding the bias, as flax does;
  * `nn.LayerNorm` has eps 1e-6 and takes its statistics in float32,
    casting the result to the compute dtype;
  * `nn.gelu` is the tanh approximation;
  * attention divides the query by sqrt(head_dim) in the compute dtype
    before QK^T, fills masked logits with the dtype's finite minimum (not
    -inf) and runs the softmax in the compute dtype. A row with no valid
    token then attends uniformly and stays finite, and pools to the zero
    vector; it is written as explicit products and `masked_fill`, because
    `scaled_dot_product_attention` gives NaN for such a row.

The reference computes all of this outside any Pallas kernel (XLA ops),
so plain torch ops are its port. `MultimodalEncoder` (image and audio
patch branches) is not ported yet and raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EncoderConfig
from ..utils import DeviceLike, resolve_device

LN_EPS = 1e-6  # flax nn.LayerNorm default


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flax nn.Dense in x's dtype: (x @ w) rounded, then + b."""
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """flax nn.LayerNorm: float32 statistics, result cast to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias,
                        eps=LN_EPS).to(x.dtype)


class TransformerLayer(nn.Module):
    """Pre-LN block: x + MHA(LN(x)), then x + MLP(LN(x)). The q/k/v
    projections are one (hidden, 3*hidden) product; `state.py` maps the
    flax (hidden, heads, head_dim) kernels onto it."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.hidden, self.heads = hidden, heads

        def p(*shape, fill=0.0):
            return nn.Parameter(torch.full(shape, fill), requires_grad=False)

        self.ln1_scale, self.ln1_bias = p(hidden, fill=1.0), p(hidden)
        self.qkv_w, self.qkv_b = p(hidden, 3 * hidden), p(3 * hidden)
        self.out_w, self.out_b = p(hidden, hidden), p(hidden)
        self.ln2_scale, self.ln2_bias = p(hidden, fill=1.0), p(hidden)
        self.mlp1_w, self.mlp1_b = p(hidden, mlp_dim), p(mlp_dim)
        self.mlp2_w, self.mlp2_b = p(mlp_dim, hidden), p(hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, hidden) in the compute dtype; mask (B, L) bool."""
        b, l, h = x.shape
        hd = h // self.heads
        dt = x.dtype
        y = _layer_norm(x, self.ln1_scale, self.ln1_bias)
        q, k, v = _dense(y, self.qkv_w, self.qkv_b).split(h, dim=-1)
        q = q.reshape(b, l, self.heads, hd).transpose(1, 2)
        k = k.reshape(b, l, self.heads, hd).transpose(1, 2)
        v = v.reshape(b, l, self.heads, hd).transpose(1, 2)
        # flax: query / sqrt(depth).astype(dtype), before the product
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
        logits = torch.matmul(q, k.transpose(-1, -2))       # (B, h, L, L)
        logits = logits.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(dt).min)
        w = torch.softmax(logits, dim=-1).to(dt)
        att = torch.matmul(w, v).transpose(1, 2).reshape(b, l, h)
        x = x + _dense(att, self.out_w, self.out_b)
        y = _layer_norm(x, self.ln2_scale, self.ln2_bias)
        y = F.gelu(_dense(y, self.mlp1_w, self.mlp1_b), approximate="tanh")
        return x + _dense(y, self.mlp2_w, self.mlp2_b)


class TextEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = _dtype(c.dtype)

        def p(*shape, fill=0.0):
            return nn.Parameter(torch.full(shape, fill), requires_grad=False)

        self.token_embed = p(c.vocab_size, c.hidden_dim)
        self.pos_embed = p(c.max_len, c.hidden_dim)
        self.layers = nn.ModuleList(
            TransformerLayer(c.hidden_dim, c.num_heads, c.mlp_dim)
            for _ in range(c.num_layers))
        self.final_ln_scale = p(c.hidden_dim, fill=1.0)
        self.final_ln_bias = p(c.hidden_dim)
        self.proj_w, self.proj_b = p(c.hidden_dim, c.out_dim), p(c.out_dim)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, *,
                return_tokens: bool = False):
        """ids (B, L) int, mask (B, L) bool -> pooled (B, out_dim) f32 unit
        vectors (zero for a row with no valid token), and with
        ``return_tokens`` also the (B, L, out_dim) f32 token outputs."""
        dt = self.dtype
        ids, mask = ids.long(), mask.bool()
        x = self.token_embed[ids].to(dt) + \
            self.pos_embed[:ids.shape[1]].to(dt)[None]
        for layer in self.layers:
            x = layer(x, mask)
        x = _layer_norm(x, self.final_ln_scale, self.final_ln_bias)
        tokens = _dense(x, self.proj_w, self.proj_b)
        # mean pooling over valid tokens (parity: huggingface.py:165-170)
        m = mask[..., None].float()
        pooled = (tokens.float() * m).sum(dim=1) / torch.clamp(
            m.sum(dim=1), min=1.0)
        pooled = pooled / torch.clamp(torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True), min=1e-12)
        if return_tokens:
            return pooled, tokens.float()
        return pooled

    def owns(self, params: Optional[Mapping[str, torch.Tensor]]) -> bool:
        """Whether ``params`` is None or this module's own parameters
        (`EncoderState.params`); others are loaded with
        ``load_state_dict``."""
        return params is None or all(
            params.get(n) is t for n, t in self.named_parameters())

    def apply(self, params: Optional[Mapping[str, torch.Tensor]],
              ids: torch.Tensor, mask: torch.Tensor, *,
              return_tokens: bool = False):
        """The reference's ``model.apply(params, ids, mask)`` call shape,
        without autograd. The module owns its weights, so ``params`` is
        not read here; `FusedSearcher.bind_encoder` checks it once with
        `owns`."""
        del params
        with torch.no_grad():
            return self(ids, mask, return_tokens=return_tokens)


class MultimodalEncoder(nn.Module):
    """Single-tower multimodal encoder (image and audio patch branches).
    Not ported yet: it needs `models/{image,audio,jpeg}.py`."""

    def __init__(self, cfg: EncoderConfig, *args, **kwargs):
        raise NotImplementedError(
            "MultimodalEncoder is not ported yet (image/audio branches)")


@dataclass
class EncoderState:
    model: TextEncoder
    params: Any   # name -> tensor: the module's own parameters
    cfg: EncoderConfig


def init_encoder(cfg: Optional[EncoderConfig] = None, *, seed: int = 0,
                 multimodal: bool = False, max_len: int = 128,
                 device: DeviceLike = None) -> EncoderState:
    """A TextEncoder with random weights from ``seed``, drawn from an
    explicit CPU `torch.Generator` (so every device gets the same
    weights) with flax's default scales: embeddings and kernels
    N(0, 1/fan_in), biases 0, norm scales 1. ``max_len`` is the
    reference's dummy sequence length at init; the weights do not depend
    on it (pos_embed spans ``cfg.max_len``)."""
    del max_len
    cfg = cfg or EncoderConfig()
    if multimodal:
        raise NotImplementedError(
            "init_encoder(multimodal=True): MultimodalEncoder is not ported "
            "yet")
    dev = resolve_device(device)
    model = TextEncoder(cfg)
    gen = torch.Generator().manual_seed(seed)
    for name, t in model.named_parameters():
        if t.dim() == 1:
            continue  # biases 0, norm scales 1 (as constructed)
        # kernels (in, out): fan_in = in; embeddings (rows, hidden): hidden
        fan_in = t.shape[0] if name.endswith("_w") else t.shape[1]
        t.copy_(torch.randn(t.shape, generator=gen) / math.sqrt(fan_in))
    model = model.to(dev)
    return EncoderState(model=model, params=dict(model.named_parameters()),
                        cfg=cfg)
