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

A grammar constraint (`constraint=`, models/constrain.py's
`Constraint.as_device`) rides the decode loop as in the reference: each
step masks the sampling logits to the tokens the row's DFA state allows
(eos exactly in accepting states), then steps the state by the consumed
token.

LoRA (models/lora.py) enters two ways, as in the reference: a wrapped
``{"w", "a", "b", "s"}`` weight leaf adds ``((x @ a) @ b) * s`` to its
base product (`_mm`), and `forward(lora={"aid", "banks"})` adds each
batch row's own rank-r delta from stacked adapter banks, in both the
einsum and the decode-kernel branch. The decode kernel itself is
unchanged: the deltas act on the projections around attention.

Training runs the same `forward` under autograd (models/train.py,
models/lora.py). When a parameter or bank requires grad, a prefill-style
call (`write_slot=None`) attends over each layer's fresh K/V instead of
views of the cache, as the reference's layer scan takes the cache
``xs -> ys``: the in-place cache writes of the next layer (or of a
`remat` recompute) then never touch a tensor autograd saved. The cache
is still written, detached. `remat=True` checkpoints each layer
(`torch.utils.checkpoint`, non-reentrant) with the numerics of
``remat=False``.

Tensor parallelism: every entry point takes a tree placed by
`parallel/tp.py::shard_params` where it takes a plain one, as the
reference takes ``jax.device_put(params, param_shardings(...))``. Each
product runs on the shards that hold its weight's slices (`_mm`), the
embedding looks up each vocabulary shard's ids (`_take_emb`), norms and
biases gather their vectors, and the MLP keeps each shard's slice of its
width between w_gate/w_up and w_down. Attention, the caches and sampling
run on the merge device on whole heads, so the decode-attention kernel
launches there as on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import decode_attn as _da
from ..parallel import tp
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
    # DeepSeek-V2 multi-head latent attention (models/mla.py) when
    # kv_lora_rank > 0: a cache of one latent (kv_lora_rank +
    # qk_rope_head_dim values) a slot in place of K and V; kv_heads and
    # head_dim are then unused
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN ("yarn" rope_kind, latent attention only; rope_factor and
    # rope_original_max_len above)
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # routed experts (models/moe.py, latent attention only) in the layers
    # from first_k_dense_replace on; 0 = a dense MLP in every layer
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    num_experts_per_tok: int = 0
    first_k_dense_replace: int = 0
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def q_groups(self) -> int:
        return self.heads // self.kv_heads

    @property
    def latent(self) -> bool:
        """Multi-head latent attention (and, with experts, DeepSeek-V2's
        block) in place of GQA."""
        return self.kv_lora_rank > 0

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def dense_layers(self) -> int:
        """Leading layers with a dense MLP; the rest hold experts."""
        return (self.first_k_dense_replace if self.n_routed_experts
                else self.num_layers)


def _dtype(cfg: DecoderConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _params_device(params: Dict[str, Any]) -> torch.device:
    """The params' device; a sharded tree's merge device."""
    emb = params["tok_emb"]
    return (emb["q"] if isinstance(emb, dict) else emb).device


def _as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor or a host array (numpy, list) as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tp.Sharded):
        yield from tree.tensors()


def _trains(params: Dict[str, Any], lora: Optional[Dict[str, Any]]) -> bool:
    """Whether autograd records this forward: grad mode is on and a
    parameter or adapter bank requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in _tensors(params)) or (
        lora is not None
        and any(t.requires_grad for t in _tensors(lora["banks"])))


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

    if cfg.latent:
        return _init_latent_params(cfg, dense, dt, dev)
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


def latent_shapes(cfg: DecoderConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                         int]]:
    """Each matrix leaf of a latent-attention tree in the stacked (in,
    out) layout, with its fan-in: attention over all layers, dense MLPs
    over the leading `dense_layers`, experts over the rest (e_* stacked
    (layer, expert, in, out); s_* the shared experts as one SwiGLU)."""
    L, H, V = cfg.num_layers, cfg.hidden, cfg.vocab_size
    nh, r = cfg.heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    Ld = cfg.dense_layers
    out = {
        "tok_emb": ((V, H), H),
        "wq": ((L, H, nh * (dn + dr)), H),
        "w_kva": ((L, H, r + dr), H),
        "w_uk": ((L, r, nh * dn), r),
        "w_uv": ((L, r, nh * dv), r),
        "wo": ((L, nh * dv, H), nh * dv),
    }
    if Ld:
        M = cfg.mlp_dim
        out.update(w_gate=((Ld, H, M), H), w_up=((Ld, H, M), H),
                   w_down=((Ld, M, H), M))
    Lm, E, F_ = L - Ld, cfg.n_routed_experts, cfg.moe_intermediate_size
    if Lm:
        out.update(router=((Lm, H, E), H), e_gate=((Lm, E, H, F_), H),
                   e_up=((Lm, E, H, F_), H), e_down=((Lm, E, F_, H), F_))
        if cfg.n_shared_experts:
            Fs = cfg.n_shared_experts * F_
            out.update(s_gate=((Lm, H, Fs), H), s_up=((Lm, H, Fs), H),
                       s_down=((Lm, Fs, H), Fs))
    out["lm_head"] = ((H, V), H)
    return out


def _init_latent_params(cfg: DecoderConfig, dense, dt: torch.dtype,
                        dev: torch.device) -> Dict[str, Any]:
    if cfg.n_routed_experts and not cfg.num_experts_per_tok:
        raise ValueError("experts need num_experts_per_tok")
    L, H = cfg.num_layers, cfg.hidden
    out = {name: dense(shape, fan_in)
           for name, (shape, fan_in) in latent_shapes(cfg).items()}
    out.update(attn_norm=torch.ones((L, H), dtype=dt, device=dev),
               ffn_norm=torch.ones((L, H), dtype=dt, device=dev),
               kva_norm=torch.ones((L, cfg.kv_lora_rank), dtype=dt,
                                   device=dev),
               final_norm=torch.ones((H,), dtype=dt, device=dev))
    return out


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


def convert_hf_deepseek_v2_state_dict(state_dict: Dict[str, Any],
                                      cfg: DecoderConfig,
                                      device: DeviceLike = None
                                      ) -> Dict[str, Any]:
    """`DeepseekV2ForCausalLM`-layout state dict (`modeling_deepseek.py`,
    ``q_lora_rank`` null) -> the latent tree of `latent_shapes`. Linear
    weights are (out, in); ours are (in, out). ``kv_b_proj`` (heads x
    (nope + v), kv_lora_rank) splits by head into W_uk (its first nope
    rows a head) and W_uv (the other v rows); ``mlp.gate`` becomes the
    router, ``mlp.experts.<e>`` and ``mlp.shared_experts`` the stacked
    e_* and s_* leaves. The rope columns of q_proj and
    kv_a_proj_with_mqa load as they are: the port's RoPE
    (models/mla.py::apply_rope) takes their adjacent pairs as the
    checkpoint's does."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    nh, dn, dv = cfg.heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    Ld, E = cfg.dense_layers, cfg.n_routed_experts

    def get(key: str) -> torch.Tensor:
        v = state_dict[key]
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().float()
        return torch.from_numpy(np.asarray(v, dtype=np.float32))

    def stacked(mats) -> torch.Tensor:
        # each layer cast on its own: a checkpoint's f32 copy of every
        # layer's experts at once would not fit on a host
        return torch.stack([m.to(dt) for m in mats]).to(dev)

    def lin(key: str) -> torch.Tensor:
        return get(key).T

    layers = range(cfg.num_layers)
    at = "model.layers.{}.self_attn."
    kvb = [get((at + "kv_b_proj.weight").format(i)).view(
        nh, dn + dv, cfg.kv_lora_rank) for i in layers]
    out = {
        "tok_emb": get("model.embed_tokens.weight").to(dt).to(dev),
        "attn_norm": stacked(get(f"model.layers.{i}.input_layernorm.weight")
                             for i in layers),
        "ffn_norm": stacked(get(
            f"model.layers.{i}.post_attention_layernorm.weight")
            for i in layers),
        "wq": stacked(lin((at + "q_proj.weight").format(i)) for i in layers),
        "w_kva": stacked(lin((at + "kv_a_proj_with_mqa.weight").format(i))
                         for i in layers),
        "kva_norm": stacked(get((at + "kv_a_layernorm.weight").format(i))
                            for i in layers),
        "w_uk": stacked(w[:, :dn].reshape(nh * dn, -1).T for w in kvb),
        "w_uv": stacked(w[:, dn:].reshape(nh * dv, -1).T for w in kvb),
        "wo": stacked(lin((at + "o_proj.weight").format(i)) for i in layers),
        "final_norm": get("model.norm.weight").to(dt).to(dev),
        "lm_head": get("lm_head.weight").T.contiguous().to(dt).to(dev),
    }
    mlp = "model.layers.{}.mlp."
    for short, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                        ("w_down", "down_proj")):
        if Ld:
            out[short] = stacked(lin((mlp + proj + ".weight").format(i))
                                 for i in range(Ld))
    moe_layers = range(Ld, cfg.num_layers)
    if E and len(moe_layers):
        out["router"] = stacked(lin((mlp + "gate.weight").format(i))
                                for i in moe_layers)
        for short, proj in (("gate", "gate_proj"), ("up", "up_proj"),
                            ("down", "down_proj")):
            out["e_" + short] = stacked(torch.stack([
                lin((mlp + f"experts.{e}.{proj}.weight").format(i))
                for e in range(E)]) for i in moe_layers)
            if cfg.n_shared_experts:
                out["s_" + short] = stacked(lin(
                    (mlp + f"shared_experts.{proj}.weight").format(i))
                    for i in moe_layers)
    return out


def quantize_decoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8: every matmul weight becomes ``{"q": int8, "s":
    f32}`` with one scale per OUTPUT channel (`tok_emb` per row, since
    it is gathered, not contracted). Norm vectors and biases stay, and so
    does an expert router (kept in bf16, as DeepSeek's inference keeps
    its gate)."""
    out = {}
    for name, w in params.items():
        if name in ("attn_norm", "ffn_norm", "final_norm",
                    "bq", "bk", "bv", "kva_norm", "router"):
            out[name] = w
            continue
        wf = w.float()
        axis = -1 if name == "tok_emb" else -2  # contraction axis
        scale = torch.amax(wf.abs(), dim=axis, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        out[name] = {"q": q, "s": scale.squeeze(axis)}
    return out


def _mm(x: Any, w: Any, split: bool = False) -> Any:
    """x @ w for a plain matrix, a quantized {"q","s"} pair, or a
    LoRA-wrapped {"w","a","b","s"} leaf (models/lora.py): the base
    product plus ((x @ a) @ b) * s, each factor cast to x.dtype, over a
    plain or quantized base; the (in, out) product is never formed. The
    quantized scale is cast to x.dtype before it multiplies, as in the
    reference.

    A sharded weight (parallel/tp.py) runs this product on each shard
    with that shard's slices (`tp.matmul`); with ``split`` an
    output-sharded product stays apart as `tp.Parts`."""
    if tp.is_sharded(w):
        return tp.matmul(x, w, _mm_one, split=split)
    return _mm_one(tp.full(x), w)


def _mm_one(x: torch.Tensor, w: Any) -> torch.Tensor:
    """`_mm` for a weight of plain tensors on x's device."""
    if isinstance(w, dict):
        if "a" in w:  # LoRA wrapper
            y = _mm_one(x, w["w"])
            lo = (x @ w["a"].to(x.dtype)) @ w["b"].to(x.dtype)
            return y + lo * w["s"].to(x.dtype)
        y = x @ w["q"].to(x.dtype)
        return y * w["s"].to(x.dtype)
    if w.dtype != x.dtype:
        # the reference's type promotion (a bf16 merge of an int8 base
        # in a float32 model computes in float32)
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def _take_emb(emb: Any, ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if tp.is_sharded(emb):
        return tp.take_rows(emb, ids, lambda e, i: _take_emb(e, i, dt))
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
    if cfg.latent:
        return _init_latent_cache(cfg, batch, length or cfg.max_len, dev)
    shape = (cfg.num_layers, batch, length or cfg.max_len,
             cfg.kv_heads, cfg.head_dim)

    def one():
        if cfg.kv_quant:
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev)}
        return torch.zeros(shape, dtype=_dtype(cfg), device=dev)

    return one(), one()


def _init_latent_cache(cfg: DecoderConfig, batch: int, length: int,
                       dev: torch.device) -> Tuple[Any, torch.Tensor]:
    """Latent attention's cache: one latent a slot, (L, B, S, 1, latent)
    (int8 with one f32 scale a slot under kv_quant), as the K half of
    the pair; the latent is also the value, so the V half is an empty
    (L, B, S, 0) placeholder that pastes, compacts and slices as the
    batcher does a V cache, moving nothing."""
    shape = (cfg.num_layers, batch, length, 1, cfg.latent_dim)
    if cfg.kv_quant:
        k = {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
             "s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}
    else:
        k = torch.zeros(shape, dtype=_dtype(cfg), device=dev)
    return k, torch.zeros(shape[:3] + (0,), dtype=torch.int8, device=dev)


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
    """The dense geometries keep the JAX package's tiling gate; latent
    attention's (MQA, 576 wide) is gated by the CUDA kernel's limits."""
    if cfg.latent:
        return _da.kernel_fits(seq_len=seq_len, head_dim=cfg.latent_dim,
                               q_groups=cfg.heads)
    return _da.supported(seq_len=seq_len, kv_heads=cfg.kv_heads,
                         head_dim=cfg.head_dim)


def _rmsnorm(x: torch.Tensor, w: Any, eps: float) -> torch.Tensor:
    w = tp.full(w)
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
    """Layer i of a stacked leaf; dict leaves (int8 pairs, caches, LoRA
    wrappers over either) slice leaf by leaf, sharded leaves shard by
    shard."""
    if isinstance(p, dict):
        return {k: _layer(v, i) for k, v in p.items()}
    if isinstance(p, tp.Sharded):
        return p.layer(i)
    return p[i]


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
    remat: bool = False,               # checkpoint each layer (training)
    lora: Optional[Dict[str, Any]] = None,  # per-ROW adapters, see below
) -> Tuple[torch.Tensor, Any, Any]:
    """One forward pass over T tokens against the cache.

    Prefill (write_slot=None): the T tokens are written at cache slots
    [0, T) — positions must be arange(T). Decode (write_slot given):
    every row's T tokens land at slots [write_slot, write_slot + T).
    Both write the caches in place and return them.

    Visibility: the query at absolute position p sees slot s iff
    slot_positions[b, s] <= p; the default is slot s holds position s.

    Multi-LoRA serving (`lora`): {"aid": (B,) int, "banks": {target:
    {"a": (L, N, in, r), "b": (L, N, r, out)}}} — each batch row applies
    its own adapter, an index into the stacked banks (models/lora.py::
    lora_banks builds them with index 0 = the zero adapter, the base).

    Returns (hidden (B, T, H), cache_k, cache_v)."""
    if cfg.latent:
        from . import latent

        return latent.forward(params, cfg, ids, positions, cache_k,
                              write_slot, slot_positions, lora), cache_k, \
            cache_v
    B, T = ids.shape
    S = cache_len(cache_k)
    dt = _dtype(cfg)
    hd, kvh, G = cfg.head_dim, cfg.kv_heads, cfg.q_groups
    train = write_slot is None and _trains(params, lora)
    if train and cfg.kv_quant:
        raise ValueError("an int8 KV cache (kv_quant) cannot be trained "
                         "through: train with kv_quant=False")
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
    layer_params = {k: params[k] for k in
                    ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                     "w_gate", "w_up", "w_down", "bq", "bk", "bv")
                    if k in params}
    if lora is not None:
        # select each row's factors ONCE (a gather over the adapter
        # axis); the (L, B, in, r) results slice per layer like weights
        aid = _as_tensor(lora["aid"], torch.long, ids.device)
        for t, bank in lora["banks"].items():
            layer_params[t + ":la"] = bank["a"].index_select(1, aid)
            layer_params[t + ":lb"] = bank["b"].index_select(1, aid)

    # checked once a forward: a one-device tree's products skip the
    # sharding dispatch (the decode loop is host-bound)
    sharded = tp.is_sharded(layer_params)

    def kv(c):
        return c["q"].to(dt) if cfg.kv_quant else c

    def proj(h, lp, name, split=False):
        """Dense projection + this row's rank-r LoRA delta (if any). Over
        sharded weights, ``split`` keeps an output-sharded result apart
        (`tp.Parts`) for the next product."""
        y = (_mm(h, lp[name], split=split) if sharded
             else _mm_one(h, lp[name]))
        la = lp.get(name + ":la")                          # (B, in, r)
        if la is None:
            return y
        h, y = tp.full(h), tp.full(y)
        lo = torch.einsum("bth,bhr->btr", h, la.to(h.dtype))
        return y + torch.einsum("btr,bro->bto", lo,
                                lp[name + ":lb"].to(h.dtype))

    def layer(x, i):
        lp = _layer(layer_params, i)
        h = _rmsnorm(x, lp["attn_norm"], cfg.eps)
        q, k, v = proj(h, lp, "wq"), proj(h, lp, "wk"), proj(h, lp, "wv")
        if "bq" in lp:  # Qwen2-family projection biases, pre-RoPE
            q = q + tp.full(lp["bq"]).to(q.dtype)
            k = k + tp.full(lp["bk"]).to(k.dtype)
            v = v + tp.full(lp["bv"]).to(v.dtype)
        q = _apply_rope(q.reshape(B, T, cfg.heads, hd), cos, sin)
        k = _apply_rope(k.reshape(B, T, kvh, hd), cos, sin)
        v = v.reshape(B, T, kvh, hd)
        if cfg.kv_quant:
            k, v = _kv_quantize(k), _kv_quantize(v)
        if train:
            # attend over this layer's fresh K/V (and the cache's slots
            # past T); the cache gets a detached copy
            with torch.no_grad():
                _write(cache_k, k.detach(), i, start)
                _write(cache_v, v.detach(), i, start)
            ck = k if S == T else torch.cat([k, cache_k[i, :, T:]], dim=1)
            cv = v if S == T else torch.cat([v, cache_v[i, :, T:]], dim=1)
        else:
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
        x = x + proj(out.reshape(B, T, cfg.heads * hd), lp, "wo")
        h = _rmsnorm(x, lp["ffn_norm"], cfg.eps)
        # sharded: w_gate and w_up split the MLP width as w_down's
        # contraction does, so each shard keeps its slice (Megatron)
        act = tp.pointwise(lambda g, u: F.silu(g) * u,
                           proj(h, lp, "w_gate", split=True),
                           proj(h, lp, "w_up", split=True))
        return x + proj(act, lp, "w_down")

    for i in range(cfg.num_layers):
        if remat and train:
            x = torch.utils.checkpoint.checkpoint(layer, x, i,
                                                  use_reentrant=False)
        else:
            x = layer(x, i)
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
                                       cache_k, cache_v, lora=lora)

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
    # grammar constraint: per-row DFA state; each step masks the sampling
    # logits to the grammar's allowed tokens (plus eos exactly in
    # accepting states), then steps the DFA by the consumed token
    if constraint is not None:
        table = constraint["table"].to(dev)
        accept = constraint["accept"].to(dev)
        is_eos = torch.arange(V, device=dev) == eos_id
    gstate = torch.zeros((B,), dtype=torch.long, device=dev)

    def emit(logits, done):
        sample_from = logits
        if bias is not None:
            sample_from = sample_from + bias[None, :]
        if penalize:
            sample_from = (sample_from
                           - presence * (counts > 0).to(logits.dtype)
                           - frequency * counts.to(logits.dtype))
        if constraint is not None:
            allowed = (table[gstate] >= 0) | (accept[gstate][:, None]
                                              & is_eos[None, :])
            sample_from = torch.where(
                allowed, sample_from,
                torch.tensor(NEG, dtype=sample_from.dtype, device=dev))
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
        if constraint is not None:
            gstate = torch.where(
                newly_done, gstate,
                table[gstate, tok.long().clamp(min=0)].long())
            gstate = gstate.clamp(min=0)  # never index with DEAD
        logits, cache_k, cache_v = decode_step(
            params, cfg, tok, pos, T + step, cache_k, cache_v,
            slot_positions=slot_pos, lora=lora)
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
