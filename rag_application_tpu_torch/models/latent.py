"""`decoder.forward` for DeepSeek-V2's block (`DecoderConfig.latent`):
multi-head latent attention (models/mla.py), then a dense SwiGLU in the
leading `dense_layers` and the expert layer (models/moe.py) in the rest.

A layer runs in four parts, each a function of tensors:

  * `_pre`: RMSNorm, W_q and W_kva, the latent's RMSNorm, RoPE, and the
    latent in the cache's form (int8 codes and a scale under `kv_quant`);
  * the latent's write into the cache at slots [start, start + T);
  * `_attn` (span ``model.mla``): expanded attention at T > 1, absorbed
    at T = 1 (through the decode kernel with `kv_quant` and
    `attn_kernel`);
  * `_post`: W_o, the residual, the MLP's RMSNorm;
  * `_mlp` (span ``model.moe`` in an expert layer): the dense SwiGLU or
    the expert layer, and the residual.

On the card, a T = 1 step through the decode kernel replays each part
but the write as a CUDA graph, captured at the second step that meets a
cache (the first runs the parts as they are and builds every kernel) and
kept while that cache lives; the batcher compacts its cache in place, so
one capture serves it for its life. The ~130 launches of a layer become
four replays and two copies, so the host no longer paces the card (a
64-row step of DeepSeek-V2-Lite: ~80 ms of dispatch op by op, ~3 ms
replayed, against ~39 ms on the card; the replay's hidden states equal
the parts' bit for bit). The graphs read static inputs (the hidden
state, the rope tables, the visibility mask) that each step fills first,
and run the same kernels on the same operands as the parts do. Host-side
counts are kept per step outside the graphs: the expert layer's pairs,
and each kernel wrapper's launches, which a replay adds as many as its
capture called (the capture itself launches nothing, and takes its
counts back). The spans' CUDA events bracket the replays, so a profiled
step is the step the timed window runs. A capture waits for a step with
no torch profiler running: graphs are captured outside the profiler and
replayed under it.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

from ..kernels import count_launch
from ..ops import decode_attn as _da
from ..ops import moe as _omoe
from ..parallel import tp
from ..utils.observability import TRACER
from . import mla, moe
from .decoder import (DecoderConfig, _attn_kernel_ok, _dtype, _kv_quantize,
                      _layer, _mm_one, _rmsnorm, _take_emb, _trains, _write,
                      cache_len)

_EXPERT_LEAVES = ("router", "e_gate", "e_up", "e_down", "s_gate", "s_up",
                  "s_down")


def _wrappers() -> Tuple[Any, ...]:
    """The kernel wrappers a step may call (looked up at each call, so a
    check that stands in for one is counted)."""
    return _da.decode_attend_int8, _omoe.moe_experts


def _pre(params, cfg: DecoderConfig, i: int, x, cos, sin):
    """(the latent in the cache's form, q_nope, q_pe) of layer i."""
    B, T, _ = x.shape
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    h = _rmsnorm(x, params["attn_norm"][i], cfg.eps)
    q = _mm_one(h, _layer(params["wq"], i)).view(B, T, cfg.heads, -1)
    kva = _mm_one(h, _layer(params["w_kva"], i))
    c = _rmsnorm(kva[..., :r], params["kva_norm"][i], mla.KVA_EPS)
    k_pe = mla.apply_rope(kva[..., None, r:], cos, sin)
    lat = torch.cat([c[:, :, None], k_pe], dim=-1)     # (B, T, 1, r + dr)
    if cfg.kv_quant:
        lat = _kv_quantize(lat)
    return lat, q[..., :dn], mla.apply_rope(q[..., dn:], cos, sin)


def _attn(params, cfg: DecoderConfig, i: int, q_nope, q_pe, lat, mask,
          kernel: bool):
    w_uk, w_uv = _layer(params["w_uk"], i), _layer(params["w_uv"], i)
    scale = mla.softmax_scale(cfg)
    if q_nope.shape[1] == 1:
        return mla.absorbed(q_nope, q_pe, lat, w_uk, w_uv, mask, scale,
                            cfg.kv_lora_rank, kernel)
    return mla.expanded(q_nope, q_pe, lat, w_uk, w_uv, mask, scale,
                        cfg.kv_lora_rank)


def _post(params, cfg: DecoderConfig, i: int, x, o):
    """(the residual stream after attention, the MLP's normed input)."""
    B, T = x.shape[:2]
    x = x + _mm_one(o.reshape(B, T, -1), _layer(params["wo"], i))
    return x, _rmsnorm(x, params["ffn_norm"][i], cfg.eps)


def _mlp(params, cfg: DecoderConfig, i: int, h):
    """(the MLP's output, the experts reached or None for a dense
    layer)."""
    Ld = cfg.dense_layers
    if i < Ld:
        return moe.swiglu(h, _layer(params["w_gate"], i),
                          _layer(params["w_up"], i),
                          _layer(params["w_down"], i)), None
    return moe.layer(h, {k: _layer(params[k], i - Ld)
                         for k in _EXPERT_LEAVES if k in params}, cfg)


def _check(params, cfg: DecoderConfig, lora, write_slot) -> None:
    if lora is not None:
        raise ValueError("LoRA adapters are not supported with latent "
                         "attention or experts")
    if tp.is_sharded(params):
        raise ValueError("tensor-parallel (sharded) trees are not "
                         "supported with latent attention or experts")
    if write_slot is None and _trains(params, None):
        raise ValueError("training is not supported with latent attention "
                         "or experts")
    if cfg.n_routed_experts and cfg.dense_layers >= cfg.num_layers:
        raise ValueError("experts need first_k_dense_replace < num_layers")


def _count(cfg: DecoderConfig, i: int, tokens: int) -> None:
    """A layer's host-side count: the expert layer's routed pairs."""
    if i >= cfg.dense_layers:
        moe.count(tokens * cfg.num_experts_per_tok)


def forward(params: Dict[str, Any], cfg: DecoderConfig, ids: torch.Tensor,
            positions: torch.Tensor, cache: Any, write_slot: Optional[int],
            slot_positions: Optional[torch.Tensor],
            lora: Optional[Dict[str, Any]]) -> torch.Tensor:
    """The hidden states of ids (B, T) at positions (B, T), the cache
    written in place as `decoder.forward` writes K/V."""
    _check(params, cfg, lora, write_slot)
    B, T = ids.shape
    S = cache_len(cache)
    dt = _dtype(cfg)
    dev = ids.device
    x = _take_emb(params["tok_emb"], ids, dt)
    cos, sin = mla.rope_tables(positions, cfg, mla.inv_freq_on(cfg, dev),
                               dt)
    if slot_positions is None:
        slots = torch.arange(S, dtype=torch.int32, device=dev)[None, None, :]
    else:
        slots = slot_positions[:, None, :]
    mask = slots <= positions[:, :, None]                  # (B, T, S)
    kernel = (cfg.kv_quant and cfg.attn_kernel and T == 1
              and _attn_kernel_ok(cfg, S))
    start = 0 if write_slot is None else int(write_slot)
    path = "decode" if T == 1 else "prefill"
    # a traced decode step's visible latents, for its spans' readers
    visible = mask.sum() if T == 1 and TRACER.on else None
    graphs = None
    if kernel and dev.type == "cuda":
        graphs = _Graphs.ready(params, cfg, cache, B, S, x, cos, sin, mask)
    if graphs is not None:
        return graphs.step(cache, start, x, cos, sin, mask, path, visible)
    for i in range(cfg.num_layers):
        lat, q_nope, q_pe = _pre(params, cfg, i, x, cos, sin)
        _write(cache, lat, i, start)
        with TRACER.span("model.mla", device=dev, layer=i, path=path,
                         tokens=B * T, slots=visible):
            o = _attn(params, cfg, i, q_nope, q_pe, _layer(cache, i), mask,
                      kernel)
        x, h = _post(params, cfg, i, x, o)
        if i < cfg.dense_layers:
            y, _ = _mlp(params, cfg, i, h)
        else:
            with TRACER.span("model.moe", device=dev, layer=i,
                             tokens=B * T) as sp:
                y, hit = _mlp(params, cfg, i, h)
                sp.set(experts=hit)
        _count(cfg, i, B * T)
        x = x + y
    return x


# ------------------------------------------------------------ CUDA graphs

# graph sets by the cache they write (its codes tensor's id); an entry
# goes when that tensor does
_SETS: Dict[int, "_Graphs"] = {}


class _Graphs:
    """One T = 1 step of every layer as CUDA graphs over one cache at one
    batch size: per layer `_pre`, `_attn`, `_post` and `_mlp` (with the
    residual add), reading static inputs, in one memory pool."""

    def __init__(self, params, cfg: DecoderConfig, B: int, S: int, x, cos,
                 sin, mask):
        self.params, self.cfg, self.key = params, cfg, (id(params), B, S)
        self.x, self.cos, self.sin = x.clone(), cos.clone(), sin.clone()
        self.mask = mask.clone()
        self.parts: List[Tuple[Any, ...]] = []
        self.launches: Tuple[int, ...] = ()
        self.captured = False

    @classmethod
    def ready(cls, params, cfg, cache, B, S, x, cos, sin, mask
              ) -> Optional["_Graphs"]:
        """The cache's captured set, capturing it at its second step (None
        at the first, which runs the parts as they are, and while a torch
        profiler runs and nothing is captured yet)."""
        codes = cache["q"]
        g = _SETS.get(id(codes))
        if g is None or g.key != (id(params), B, S) or g.params is not params:
            g = _SETS[id(codes)] = cls(params, cfg, B, S, x, cos, sin, mask)
            weakref.finalize(codes, _SETS.pop, id(codes), None)
            return None
        if not g.captured:
            if _profiler._is_profiler_enabled:
                return None
            g.capture(cache)
        return g

    def capture(self, cache) -> None:
        params, cfg = self.params, self.cfg
        dev = self.x.device
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))

        def graph(fn):
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            out = fn()
            g.capture_end()
            return g, out

        before = [w.launches for w in _wrappers()]
        with torch.cuda.stream(side):
            for i in range(cfg.num_layers):
                g_pre, (lat, qn, qpe) = graph(lambda: _pre(
                    params, cfg, i, self.x, self.cos, self.sin))
                g_attn, o = graph(lambda: _attn(
                    params, cfg, i, qn, qpe, _layer(cache, i), self.mask,
                    True))

                def post():
                    xn, h = _post(params, cfg, i, self.x, o)
                    self.x.copy_(xn)
                    return h

                g_post, h = graph(post)

                def mlp():
                    y, hit = _mlp(params, cfg, i, h)
                    self.x.add_(y)
                    return hit

                g_mlp, hit = graph(mlp)
                self.parts.append((g_pre, lat, g_attn, g_post, g_mlp, hit))
        torch.cuda.current_stream(dev).wait_stream(side)
        # the wrappers counted the calls captured, which ran nothing: a
        # replay adds them
        self.launches = tuple(w.launches - n
                              for w, n in zip(_wrappers(), before))
        for w, n in zip(_wrappers(), self.launches):
            count_launch(w, n=-n)
        self.captured = True

    def step(self, cache, start: int, x, cos, sin, mask, path: str,
             visible) -> torch.Tensor:
        cfg = self.cfg
        dev = x.device
        B = x.shape[0]
        self.x.copy_(x)
        self.cos.copy_(cos)
        self.sin.copy_(sin)
        self.mask.copy_(mask)
        for i, (g_pre, lat, g_attn, g_post, g_mlp, hit) in enumerate(
                self.parts):
            g_pre.replay()
            _write(cache, lat, i, start)
            with TRACER.span("model.mla", device=dev, layer=i, path=path,
                             tokens=B, slots=visible):
                g_attn.replay()
            g_post.replay()
            if i < cfg.dense_layers:
                g_mlp.replay()
            else:
                with TRACER.span("model.moe", device=dev, layer=i,
                                 tokens=B) as sp:
                    g_mlp.replay()
                    if TRACER.on:
                        sp.set(experts=hit.clone())
            _count(cfg, i, B)
        for w, n in zip(_wrappers(), self.launches):
            count_launch(w, n=n)
        return self.x.clone()
