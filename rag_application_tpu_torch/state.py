"""Build the port's indexes and decoder from the JAX package's state,
given as numpy.

The "weights carried across" of this system are the index tables: with
these, both packages search identical tables (the tests hold the port
against the reference on them), whatever rounding their insert paths
differ by. The arrays come from `np.asarray` of the JAX index's device
arrays; bf16 planes arrive as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses, so they are carried as their ``.view(np.uint16)``
bits and rebuilt with ``.view(torch.bfloat16)``. The decoder's and the
text encoder's weights are carried the same way (`decoder_params_from_jax`,
`encoder_params_from_jax`, and `bert_params_from_jax` for the BERT
encoder), so both packages run the same model; LoRA adapters and wrapped
decoder trees cross with `adapters_from_jax` and back with
`adapters_to_numpy`. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import EncoderConfig, IndexConfig, SparseConfig
from .index.dense import DenseIndex
from .index.sparse import SparseIndex
from .models.decoder import DecoderConfig
from .utils import DeviceLike, resolve_device


def _tensor(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


def bf16_from_bits(bits: np.ndarray, device: DeviceLike = None
                   ) -> torch.Tensor:
    """uint16 bf16 bits (numpy) -> bf16 tensor on ``device``."""
    if bits.dtype != np.uint16:
        raise TypeError(f"bf16 planes are carried as uint16 bits, got "
                        f"{bits.dtype}")
    return _tensor(bits, device).view(torch.bfloat16)


def dense_from_numpy(cfg: IndexConfig, arrays: Mapping[str, np.ndarray],
                     size: int, has_deletes: bool, *,
                     device: DeviceLike = None) -> DenseIndex:
    """DenseIndex holding the given tables. ``arrays``: ``vecs`` (uint16
    bf16 bits or None), ``int8``, ``inv_norms``, ``int8_recip``, ``live``,
    ``prefix_int8`` — each None where the storage mode has no such plane.
    """
    idx = DenseIndex(cfg, device=device)
    dev = idx.device
    vecs = arrays.get("vecs")
    tables: Dict[str, Optional[torch.Tensor]] = {
        "vecs": bf16_from_bits(vecs, dev) if vecs is not None else None,
        "int8": _tensor(arrays.get("int8"), dev),
        "inv_norms": _tensor(arrays["inv_norms"], dev),
        "int8_recip": _tensor(arrays.get("int8_recip"), dev),
        "live": _tensor(arrays["live"], dev),
        "prefix_int8": _tensor(arrays.get("prefix_int8"), dev),
    }
    for name, t in tables.items():
        have = getattr(idx, name) is not None
        if have != (t is not None):
            raise ValueError(f"{name}: the config {'expects' if have else 'has no'}"
                             f" this plane")
        setattr(idx, name, t)
    cap = idx.capacity
    if any(t is not None and t.shape[0] != cap for t in tables.values()):
        raise ValueError("all planes must have the same capacity")
    if not 0 <= size <= cap:
        raise ValueError(f"size {size} outside capacity {cap}")
    idx.size = int(size)
    idx.has_deletes = bool(has_deletes)
    return idx


def sparse_from_numpy(cfg: SparseConfig, arrays: Mapping[str, np.ndarray],
                      vocab: Mapping[str, int], *,
                      device: DeviceLike = None) -> SparseIndex:
    """SparseIndex holding the given device views and host CSR.

    ``arrays``: device views ``post_docs``, ``post_weights`` (None for the
    packed layout), ``doc_packed``, ``v_pad``; host CSR ``terms``, ``tfs``,
    ``counts``, ``lens`` (as `SparseIndex._flat()` returns them) and
    ``deleted`` (tombstoned rows), so later inserts rebuild on top of the
    carried documents. ``vocab`` is the analyzer vocabulary (term -> id).
    """
    idx = SparseIndex(cfg, device=device)
    idx.analyzer.vocab = dict(vocab)
    counts = np.asarray(arrays["counts"], dtype=np.int32)
    idx._append_chunk(arrays["terms"], arrays["tfs"], counts, arrays["lens"])
    idx._deleted = {int(r) for r in np.asarray(arrays["deleted"]).ravel()}
    dev = idx.device
    post_w = arrays.get("post_weights")
    doc_packed = _tensor(arrays["doc_packed"], dev)
    if doc_packed.shape[0] != idx._n_docs + 1:
        raise ValueError("doc_packed must hold one row per doc + sentinel")
    idx._device = {
        "post_docs": _tensor(arrays["post_docs"], dev),
        "post_weights": _tensor(post_w, dev) if post_w is not None else None,
        "doc_packed": doc_packed,
        "v_pad": int(arrays["v_pad"]),
    }
    idx._dirty = False
    return idx


def _float_leaf(name: str, a: Any, device, want=None) -> torch.Tensor:
    """A carried float leaf: uint16 bits -> bf16, float32 as it is;
    ``want`` (a numpy dtype), where given, is the only one accepted."""
    a = np.asarray(a)
    if a.dtype not in (np.uint16, np.float32) or (want is not None
                                                  and a.dtype != want):
        raise TypeError(f"{name}: expected "
                        f"{np.dtype(want) if want else 'uint16 or float32'}"
                        f" leaves, got {a.dtype}")
    return (bf16_from_bits(a, device) if a.dtype == np.uint16
            else _tensor(a, device))


def _quantized_from_jax(name: str, leaf: Mapping[str, Any],
                        device) -> Dict[str, torch.Tensor]:
    q, s = np.asarray(leaf["q"]), np.asarray(leaf["s"])
    if q.dtype != np.int8 or s.dtype != np.float32:
        raise TypeError(f"{name}: quantized leaves are int8 q and "
                        f"f32 s, got {q.dtype} and {s.dtype}")
    return {"q": _tensor(q, device), "s": _tensor(s, device)}


def adapters_from_jax(adapters: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """A LoRA adapter tree ({target: {"a", "b", optional "s"}}, as
    models/lora.py's `lora_adapters` or `load_adapters` give it) from the
    JAX package, as numpy: bf16 factors as their uint16 bits, float32
    factors and scales as they are."""
    return {t: {k: _float_leaf(f"{t}.{k}", v, device,
                               np.float32 if k == "s" else None)
                for k, v in ab.items()}
            for t, ab in adapters.items()}


def adapters_to_numpy(adapters: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's adapter tree as float32 numpy (bf16 widens exactly),
    to compare with the JAX package's factors."""
    return {t: {k: v.detach().float().cpu().numpy() for k, v in ab.items()}
            for t, ab in adapters.items()}


def decoder_params_from_jax(params: Mapping[str, Any], cfg: DecoderConfig,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The port's decoder params from a JAX decoder param tree given as
    numpy arrays: bf16 leaves as their uint16 bits, float32 leaves as
    they are, and int8-quantized ``{"q", "s"}`` leaves carried exactly.
    The leaves' float type must be ``cfg.dtype``'s (norms and biases
    included), as the JAX package makes them. A LoRA-wrapped leaf
    (``{"w", "a", "b", "s"}``, models/lora.py) carries its base the same
    way and its factors as `adapters_from_jax` does."""
    want = np.uint16 if cfg.dtype == "bfloat16" else np.dtype(cfg.dtype)

    def base(name, leaf):
        if isinstance(leaf, Mapping):
            return _quantized_from_jax(name, leaf, device)
        return _float_leaf(name, leaf, device, want)

    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if isinstance(leaf, Mapping) and "a" in leaf:
            out[name] = {"w": base(name, leaf["w"]),
                         **adapters_from_jax(
                             {name: {k: leaf[k] for k in ("a", "b", "s")}},
                             device)[name]}
        else:
            out[name] = base(name, leaf)
    return out


def encoder_params_from_jax(params: Mapping[str, Any], cfg: EncoderConfig,
                            device: DeviceLike = None
                            ) -> Dict[str, torch.Tensor]:
    """The port's `TextEncoder` or `MultimodalEncoder` state (name -> f32
    tensor, for `load_state_dict`) from a flax param tree of either tower
    given as numpy (every leaf f32, with or without the top-level
    ``"params"``). The q/k/v kernels (hidden, heads, head_dim) and biases
    (heads, head_dim) become one (hidden, 3*hidden) product and its bias;
    the output kernel (heads, head_dim, hidden) a (hidden, hidden) one.
    A multimodal tree's patch-embed conv kernels (p, p, C, hidden) become
    (p * p * C, hidden) products; the position tables pass as they are."""
    p = params.get("params", params)
    h = cfg.hidden_dim
    dev = resolve_device(device)

    def leaf(*path) -> np.ndarray:
        node: Any = p
        for k in path:
            node = node[k]
        a = np.asarray(node)
        if a.dtype != np.float32:
            raise TypeError(f"{'/'.join(path)}: f32 leaves expected, got "
                            f"{a.dtype}")
        return a

    out: Dict[str, np.ndarray] = {
        "token_embed": leaf("token_embed", "embedding"),
        "pos_embed": leaf("pos_embed", "embedding"),
        "final_ln_scale": leaf("final_ln", "scale"),
        "final_ln_bias": leaf("final_ln", "bias"),
        "proj_w": leaf("proj", "kernel"),
        "proj_b": leaf("proj", "bias"),
    }
    if "patch_embed" in p:
        for src, dst in (("patch_embed", "patch"),
                         ("audio_patch_embed", "audio_patch")):
            out[dst + "_w"] = leaf(src, "kernel").reshape(-1, h)
            out[dst + "_b"] = leaf(src, "bias")
            out[dst + "_pos"] = leaf(dst + "_pos")
    for i in range(cfg.num_layers):
        lp = f"layer_{i}"
        att = (lp, "MultiHeadDotProductAttention_0")
        pre = f"layers.{i}."
        out[pre + "ln1_scale"] = leaf(lp, "LayerNorm_0", "scale")
        out[pre + "ln1_bias"] = leaf(lp, "LayerNorm_0", "bias")
        out[pre + "ln2_scale"] = leaf(lp, "LayerNorm_1", "scale")
        out[pre + "ln2_bias"] = leaf(lp, "LayerNorm_1", "bias")
        out[pre + "qkv_w"] = np.concatenate(
            [leaf(*att, n, "kernel").reshape(h, h)
             for n in ("query", "key", "value")], axis=1)
        out[pre + "qkv_b"] = np.concatenate(
            [leaf(*att, n, "bias").reshape(h) for n in ("query", "key",
                                                        "value")])
        out[pre + "out_w"] = leaf(*att, "out", "kernel").reshape(h, h)
        out[pre + "out_b"] = leaf(*att, "out", "bias")
        out[pre + "mlp1_w"] = leaf(lp, "Dense_0", "kernel")
        out[pre + "mlp1_b"] = leaf(lp, "Dense_0", "bias")
        out[pre + "mlp2_w"] = leaf(lp, "Dense_1", "kernel")
        out[pre + "mlp2_b"] = leaf(lp, "Dense_1", "bias")
    return {name: _tensor(a, dev) for name, a in out.items()}


def bert_params_from_jax(params: Mapping[str, Any], device: DeviceLike = None
                         ) -> Dict[str, torch.Tensor]:
    """The port's `models.bert.BertEncoder` state (name -> f32 tensor, for
    `load_state_dict`) from a flax `BertEncoder` param tree given as numpy
    (with or without the top-level ``"params"``). The q/k/v kernels
    (hidden, heads, head_dim) and biases (heads, head_dim) become
    `Linear` weights (out, in) and biases; the output kernel (heads,
    head_dim, hidden) one (hidden, hidden) weight; Dense kernels (in,
    out) are transposed."""
    p = params.get("params", params)
    dev = resolve_device(device)

    def leaf(*path) -> np.ndarray:
        node: Any = p
        for k in path:
            node = node[k]
        return np.asarray(node, dtype=np.float32)

    h = leaf("word_emb", "embedding").shape[1]
    out: Dict[str, np.ndarray] = {
        "word_emb.weight": leaf("word_emb", "embedding"),
        "pos_emb.weight": leaf("pos_emb", "embedding"),
        "type_emb.weight": leaf("type_emb", "embedding"),
        "emb_ln.weight": leaf("emb_ln", "scale"),
        "emb_ln.bias": leaf("emb_ln", "bias"),
    }
    i = 0
    while f"layer_{i}" in p:
        lp, pre = f"layer_{i}", f"layers.{i}."
        for n in ("query", "key", "value"):
            out[pre + n + ".weight"] = leaf(lp, "attn", n, "kernel").reshape(
                h, h).T
            out[pre + n + ".bias"] = leaf(lp, "attn", n, "bias").reshape(h)
        out[pre + "out.weight"] = leaf(lp, "attn", "out", "kernel").reshape(
            h, h).T
        out[pre + "out.bias"] = leaf(lp, "attn", "out", "bias")
        for n in ("ffn_in", "ffn_out"):
            out[pre + n + ".weight"] = leaf(lp, n, "kernel").T
            out[pre + n + ".bias"] = leaf(lp, n, "bias")
        for n in ("attn_ln", "ffn_ln"):
            out[pre + n + ".weight"] = leaf(lp, n, "scale")
            out[pre + n + ".bias"] = leaf(lp, n, "bias")
        i += 1
    return {name: _tensor(np.ascontiguousarray(a), dev)
            for name, a in out.items()}
