"""Faithful BERT-family encoder (post-LN) + HF weight import, in PyTorch.

Port of `rag_application_tpu/models/bert.py`. The reference's HF local
client runs BERT-family sentence encoders with a mean-pooled last hidden
state; this module is the exact BERT computation (embeddings LayerNorm,
post-LN blocks, erf GELU, LayerNorm eps 1e-12) so existing HF checkpoints
(MiniLM, BERT, MPNet-style) give the same embeddings on the card.
`convert_hf_state_dict` maps a torch BERT state dict onto this module's
parameters (`state.bert_params_from_jax` carries the flax `BertEncoder`'s
instead). Attention scores and softmax are f32 with masked keys at the
dtype's minimum, as flax's attention takes them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import DeviceLike, resolve_device


class BertLayer(nn.Module):
    """Post-LN block: self-attention + LayerNorm, erf-GELU MLP +
    LayerNorm."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 eps: float = 1e-12):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)
        self.attn_ln = nn.LayerNorm(hidden, eps=eps)
        self.ffn_in = nn.Linear(hidden, mlp_dim)
        self.ffn_out = nn.Linear(mlp_dim, hidden)
        self.ffn_ln = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, H = x.shape
        hd = H // self.heads

        def split(t):
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        a = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, H)
        x = self.attn_ln(x + self.out(a))
        f = self.ffn_out(F.gelu(self.ffn_in(x), approximate="none"))
        return self.ffn_ln(x + f)


class BertEncoder(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, post-LN
    blocks; `forward` returns the mask-mean-pooled, L2-normalized last
    hidden state (and the token states with ``return_tokens``)."""

    def __init__(self, vocab_size: int, hidden: int, num_layers: int,
                 heads: int, mlp_dim: int, max_len: int = 512,
                 type_vocab: int = 2, eps: float = 1e-12):
        super().__init__()
        self.word_emb = nn.Embedding(vocab_size, hidden)
        self.pos_emb = nn.Embedding(max_len, hidden)
        self.type_emb = nn.Embedding(type_vocab, hidden)
        self.emb_ln = nn.LayerNorm(hidden, eps=eps)
        self.layers = nn.ModuleList(
            [BertLayer(hidden, heads, mlp_dim, eps=eps)
             for _ in range(num_layers)])

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, *,
                return_tokens: bool = False):
        ids = ids.long()
        mask = mask.bool()
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (self.word_emb(ids) + self.pos_emb(pos)[None]
             + self.type_emb(torch.zeros_like(ids)))
        x = self.emb_ln(x)
        for layer in self.layers:
            x = layer(x, mask)
        m = mask[..., None].float()
        pooled = (x.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1),
                                                          min=1.0)
        pooled = pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
            min=1e-12)
        if return_tokens:
            return pooled, x.float()
        return pooled


def convert_hf_state_dict(state_dict: Dict[str, Any], *, hidden: int,
                          heads: int, num_layers: int
                          ) -> Dict[str, torch.Tensor]:
    """torch BERT state dict -> this module's state dict (f32 tensors).

    Accepts `bert.`-prefixed or bare keys (BertModel.state_dict()); both
    layouts are torch `Linear`s, so weights carry over untransposed.
    `hidden` and `heads` are checked against the weights' shapes."""

    def get(key: str) -> torch.Tensor:
        for k in (key, f"bert.{key}"):
            if k in state_dict:
                v = state_dict[k]
                v = (v.detach().cpu() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.asarray(v)))
                return v.float().clone()
        raise KeyError(key)

    out: Dict[str, torch.Tensor] = {
        "word_emb.weight": get("embeddings.word_embeddings.weight"),
        "pos_emb.weight": get("embeddings.position_embeddings.weight"),
        "type_emb.weight": get("embeddings.token_type_embeddings.weight"),
        "emb_ln.weight": get("embeddings.LayerNorm.weight"),
        "emb_ln.bias": get("embeddings.LayerNorm.bias"),
    }
    if out["word_emb.weight"].shape[1] != hidden or hidden % heads:
        raise ValueError(f"hidden {hidden} / heads {heads} do not fit the "
                         f"embeddings {tuple(out['word_emb.weight'].shape)}")
    names = {"query": "attention.self.query",
             "key": "attention.self.key",
             "value": "attention.self.value",
             "out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm",
             "ffn_in": "intermediate.dense",
             "ffn_out": "output.dense",
             "ffn_ln": "output.LayerNorm"}
    for i in range(num_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = get(
                    f"encoder.layer.{i}.{theirs}.{leaf}")
    return out


def load_hf_encoder(model_dir_or_state: Any, config: Optional[Dict] = None,
                    device: DeviceLike = None
                    ) -> Tuple[BertEncoder, Dict[str, torch.Tensor]]:
    """Build (BertEncoder with the weights loaded, its state dict) from a
    HF checkpoint directory or an in-memory state dict + config, on
    ``device`` (default: cuda). Directory loading reads
    `pytorch_model.bin` or `model.safetensors` (local files only — the
    framework never downloads)."""
    if isinstance(model_dir_or_state, str):
        import json
        import os

        with open(os.path.join(model_dir_or_state, "config.json")) as f:
            config = json.load(f)
        weights = os.path.join(model_dir_or_state, "pytorch_model.bin")
        st_path = os.path.join(model_dir_or_state, "model.safetensors")
        if os.path.exists(weights):
            state = torch.load(weights, map_location="cpu")
        elif os.path.exists(st_path):
            # modern checkpoints ship safetensors only (the transformers
            # default save format since 4.35)
            from safetensors.torch import load_file

            state = load_file(st_path)
        else:
            raise FileNotFoundError(
                f"no pytorch_model.bin or model.safetensors in "
                f"{model_dir_or_state}")
    else:
        state = model_dir_or_state
        if config is None:
            raise ValueError("an in-memory state dict needs its config")
    model = BertEncoder(
        vocab_size=config["vocab_size"],
        hidden=config["hidden_size"],
        num_layers=config["num_hidden_layers"],
        heads=config["num_attention_heads"],
        mlp_dim=config["intermediate_size"],
        max_len=config.get("max_position_embeddings", 512),
        type_vocab=config.get("type_vocab_size", 2),
        eps=config.get("layer_norm_eps", 1e-12),
    )
    params = convert_hf_state_dict(
        state, hidden=config["hidden_size"],
        heads=config["num_attention_heads"],
        num_layers=config["num_hidden_layers"])
    model.load_state_dict(params)
    return model.to(resolve_device(device)).eval(), params
