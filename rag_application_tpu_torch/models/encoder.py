"""The text encoder (768-d, v1 parity) and the multimodal tower as
PyTorch modules.

Port of `rag_application_tpu/models/encoder.py` (`TransformerLayer`,
`TextEncoder`, `MultimodalEncoder`, `EncoderState`, `init_encoder`): a
pre-LN transformer encoder, mean-pooled over the attention mask and
L2-normalized. The flax modules' numerics are kept where they differ
from PyTorch's habits:

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
    `scaled_dot_product_attention` gives NaN for such a row;
  * the multimodal tower's patch embeds (flax `nn.Conv`, a 16x16 kernel
    at stride 16 in bf16) are a reshape into non-overlapping patches and
    one dense product: the flax kernel (16, 16, C, hidden) HWIO flattens
    row-major into (16 * 16 * C, hidden), in the order the patches
    flatten (patch row, patch column, channel); the input and kernel are
    cast to the compute dtype first and the product rounded before the
    bias, as flax promotes and rounds the conv.

The reference computes all of this outside any Pallas kernel (XLA ops),
so plain torch ops are its port.

Tensor parallelism: ``forward(..., params=...)`` runs the same math over
a parameter map (name -> leaf) instead of the module's own weights, and
its leaves may be sharded (parallel/tp.py::shard_params): `_dense` runs
on the shards that hold its kernel's slices, `_layer_norm` gathers its
vectors, the embeddings look up each shard's rows. `apply` takes such a
map, and `models/train.py`'s encoder step, sharded or not,
differentiates through this route.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EncoderConfig
from ..parallel import tp
from ..utils import DeviceLike, resolve_device

LN_EPS = 1e-6  # flax nn.LayerNorm default


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def _dense(x: torch.Tensor, w: Any, b: Any) -> torch.Tensor:
    """flax nn.Dense in x's dtype: (x @ w) rounded, then + b."""
    return tp.matmul(x, w, _mm) + tp.full(b).to(x.dtype)


def _layer_norm(x: torch.Tensor, scale: Any, bias: Any) -> torch.Tensor:
    """flax nn.LayerNorm: float32 statistics, result cast to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), tp.full(scale),
                        tp.full(bias), eps=LN_EPS).to(x.dtype)


def _rows(table: Any, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a tensor or a sharded table."""
    if isinstance(table, tp.Sharded):
        return tp.take_rows(table, ids, lambda t, i: t[i])
    return table[ids]


class _View:
    """A parameter map's leaves under ``prefix`` as attributes, in place
    of a module's own parameters."""

    def __init__(self, params: Mapping[str, Any], prefix: str = ""):
        self._params, self._prefix = params, prefix

    def __getattr__(self, name: str) -> Any:
        return self._params[self._prefix + name]


def _block(p: Any, heads: int, x: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """`TransformerLayer`'s math over the weights of ``p`` (the module,
    or a `_View` of a parameter map)."""
    b, l, h = x.shape
    hd = h // heads
    dt = x.dtype
    y = _layer_norm(x, p.ln1_scale, p.ln1_bias)
    q, k, v = _dense(y, p.qkv_w, p.qkv_b).split(h, dim=-1)
    q = q.reshape(b, l, heads, hd).transpose(1, 2)
    k = k.reshape(b, l, heads, hd).transpose(1, 2)
    v = v.reshape(b, l, heads, hd).transpose(1, 2)
    # flax: query / sqrt(depth).astype(dtype), before the product
    q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
    logits = torch.matmul(q, k.transpose(-1, -2))       # (B, h, L, L)
    logits = logits.masked_fill(~mask[:, None, None, :],
                                torch.finfo(dt).min)
    w = torch.softmax(logits, dim=-1).to(dt)
    att = torch.matmul(w, v).transpose(1, 2).reshape(b, l, h)
    x = x + _dense(att, p.out_w, p.out_b)
    y = _layer_norm(x, p.ln2_scale, p.ln2_bias)
    y = F.gelu(_dense(y, p.mlp1_w, p.mlp1_b), approximate="tanh")
    return x + _dense(y, p.mlp2_w, p.mlp2_b)


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
        return _block(self, self.heads, x, mask)


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
                return_tokens: bool = False, params=None):
        """ids (B, L) int, mask (B, L) bool -> pooled (B, out_dim) f32 unit
        vectors (zero for a row with no valid token), and with
        ``return_tokens`` also the (B, L, out_dim) f32 token outputs.
        ``params`` (name -> tensor or sharded leaf) replaces the
        module's own weights."""
        ids, mask = ids.long(), mask.bool()
        return self._tower(self._embed_text(ids, params), mask,
                           return_tokens, params)

    def _embed_text(self, ids: torch.Tensor, params=None) -> torch.Tensor:
        """Token plus position embeddings, (B, L, hidden) in the compute
        dtype."""
        dt = self.dtype
        p = self if params is None else _View(params)
        if isinstance(p.pos_embed, tp.Sharded):
            pos = _rows(p.pos_embed, torch.arange(ids.shape[1],
                                                  device=ids.device))
        else:
            pos = p.pos_embed[:ids.shape[1]]
        return _rows(p.token_embed, ids).to(dt) + pos.to(dt)[None]

    def _tower(self, x: torch.Tensor, mask: torch.Tensor,
               return_tokens: bool, params=None):
        """The layer stack, final norm, projection and masked mean pool
        over ``mask`` (B, L) of the sequence ``x`` (B, L, hidden)."""
        for i, layer in enumerate(self.layers):
            lp = layer if params is None else _View(params, f"layers.{i}.")
            x = _block(lp, layer.heads, x, mask)
        p = self if params is None else _View(params)
        x = _layer_norm(x, p.final_ln_scale, p.final_ln_bias)
        tokens = _dense(x, p.proj_w, p.proj_b)
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
              *inputs: Optional[torch.Tensor], return_tokens: bool = False):
        """The reference's ``model.apply(params, ids, mask, ...)`` call
        shape (the multimodal tower's also takes images, image_mask,
        audio, audio_mask), without autograd. The module owns its
        weights, so plain ``params`` are not read here
        (`FusedSearcher.bind_encoder` checks them once with `owns`); a
        sharded map (parallel/tp.py::shard_params) runs in their
        place."""
        sharded = params if tp.is_sharded(params) else None
        with torch.no_grad():
            return self(*inputs, return_tokens=return_tokens,
                        params=sharded)


def _patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p * p * C): non-overlapping p x p
    patches in row-major patch order, each flattened (row, column,
    channel) like a flax HWIO conv kernel."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


class MultimodalEncoder(TextEncoder):
    """Single-tower multimodal encoder: image and audio patches as
    prefix tokens (ImageBind-style), the counterpart of the reference's
    flax `MultimodalEncoder`.

    An image (B, 224, 224, 3) becomes 14 x 14 = 196 patch tokens, a
    log-mel clip (B, 256, 128) 16 x 8 = 128, each plus its own learned
    position table. The sequence is audio, then image, then text tokens,
    and so is the mask; a missing ``image_mask``/``audio_mask`` is all
    true. Without images and audio it is the `TextEncoder`."""

    patch_size = 16
    image_size = 224
    audio_frames = 256
    audio_mels = 128

    def __init__(self, cfg: EncoderConfig):
        super().__init__(cfg)
        h, p = cfg.hidden_dim, self.patch_size

        def param(*shape):
            return nn.Parameter(torch.zeros(shape), requires_grad=False)

        self.patch_w, self.patch_b = param(p * p * 3, h), param(h)
        self.patch_pos = param((self.image_size // p) ** 2, h)
        self.audio_patch_w, self.audio_patch_b = param(p * p, h), param(h)
        self.audio_patch_pos = param(
            (self.audio_frames // p) * (self.audio_mels // p), h)

    def _embed_patches(self, x: torch.Tensor, w: Any, b: Any,
                       pos: Any) -> torch.Tensor:
        """flax nn.Conv(hidden, (p, p), strides=(p, p), dtype) on
        (B, H, W, C) plus the position table, (B, P, hidden)."""
        patches = _dense(_patches(x.to(self.dtype), self.patch_size), w, b)
        if patches.shape[1] != pos.shape[0]:
            raise ValueError(f"{patches.shape[1]} patches, but the position "
                             f"table holds {pos.shape[0]}")
        if isinstance(pos, tp.Sharded):
            pos = _rows(pos, torch.arange(pos.shape[0], device=x.device))
        return patches + pos.to(self.dtype)[None]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                images: Optional[torch.Tensor] = None,
                image_mask: Optional[torch.Tensor] = None,
                audio: Optional[torch.Tensor] = None,
                audio_mask: Optional[torch.Tensor] = None, *,
                return_tokens: bool = False, params=None):
        """ids, mask (B, L); images (B, 224, 224, 3) float; audio
        (B, 256, 128) log-mel; image_mask, audio_mask (B,) bool -> pooled
        (B, out_dim) f32 unit vectors, and with ``return_tokens`` the
        (B, L_audio + L_image + L, out_dim) f32 token outputs.
        ``params`` replaces the module's own weights."""
        ids, mask = ids.long(), mask.bool()
        p = self if params is None else _View(params)
        x = self._embed_text(ids, params)
        if images is not None:
            x, mask = self._prepend(x, mask, image_mask, self._embed_patches(
                images, p.patch_w, p.patch_b, p.patch_pos))
        if audio is not None:
            x, mask = self._prepend(x, mask, audio_mask, self._embed_patches(
                audio[..., None], p.audio_patch_w, p.audio_patch_b,
                p.audio_patch_pos))
        return self._tower(x, mask, return_tokens, params)

    @staticmethod
    def _prepend(x, mask, media_mask, patches):
        """``patches`` (B, P, hidden) before the sequence ``x``, and their
        rows of ``media_mask`` (B,) (all true when None) before ``mask``."""
        b, n = patches.shape[:2]
        if media_mask is None:
            media_mask = torch.ones(b, dtype=torch.bool, device=mask.device)
        pmask = media_mask.bool()[:, None].expand(b, n)
        return torch.cat([patches, x], dim=1), torch.cat([pmask, mask], dim=1)


@dataclass
class EncoderState:
    model: TextEncoder  # or its subclass MultimodalEncoder
    params: Any   # name -> tensor: the module's own parameters
    cfg: EncoderConfig


def init_encoder(cfg: Optional[EncoderConfig] = None, *, seed: int = 0,
                 multimodal: bool = False, max_len: int = 128,
                 device: DeviceLike = None) -> EncoderState:
    """A TextEncoder (a MultimodalEncoder with ``multimodal``) with random
    weights from ``seed``, drawn from an explicit CPU `torch.Generator`
    (so every device gets the same weights) with flax's default scales:
    embeddings and kernels (the patch embeds' too) N(0, 1/fan_in), the
    two patch position tables N(0, 0.02^2), biases 0, norm scales 1.
    ``max_len`` is the reference's dummy sequence length at init; the
    weights do not depend on it (pos_embed spans ``cfg.max_len``)."""
    del max_len
    cfg = cfg or EncoderConfig()
    dev = resolve_device(device)
    model = MultimodalEncoder(cfg) if multimodal else TextEncoder(cfg)
    gen = torch.Generator().manual_seed(seed)
    # the patch branches draw last: the text weights are the text tower's
    for name, t in sorted(model.named_parameters(),
                          key=lambda nt: "patch" in nt[0]):
        if t.dim() == 1:
            continue  # biases 0, norm scales 1 (as constructed)
        if name.endswith("patch_pos"):
            t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
            continue
        # kernels (in, out): fan_in = in; embeddings (rows, hidden): hidden
        fan_in = t.shape[0] if name.endswith("_w") else t.shape[1]
        t.copy_(torch.randn(t.shape, generator=gen) / math.sqrt(fan_in))
    model = model.to(dev)
    return EncoderState(model=model, params=dict(model.named_parameters()),
                        cfg=cfg)
