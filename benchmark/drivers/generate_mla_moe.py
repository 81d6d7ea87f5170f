"""Closed-loop clients of the port's continuous batcher serving a
DeepSeek-V2 decoder: multi-head latent attention and routed + shared
experts (`DecoderConfig`'s latent fields, models/mla.py, models/moe.py).

The configuration is the model's published `config.json` with the
serving precision it states; the mix is read as the `generate` driver
reads it, and this driver runs that driver's serving loop and window
(`generate._serve`): a shared system prompt registered as the cached
prefix, a retrieved context and a question, greedy new tokens with no
end-of-sequence token. Weights are made from the seed on the card, one
leaf of one layer at a time (`reference.deepseek_v2.draw`, the draws the
reference makes again), each quantized by the port as it is drawn and
written into the stacked tree of `decoder.latent_shapes`.

After the window, the plain reference (benchmark/reference/
deepseek_v2.py) teacher-forces the longest finished request and a
seeded sample of the others and reads how far each served token's
logit lies below its best (`served_logit_gap`).
"""

from __future__ import annotations

import asyncio
import gc
import time
from typing import Any, Dict, List

import torch

from benchmark import data, harness, roofline_moe
from benchmark.drivers import generate as gen
from benchmark.reference import deepseek_v2 as ref

# the reference's per-layer leaves -> the port's stacked leaves
ATTN = {"q_proj": "wq", "kv_a_proj_with_mqa": "w_kva", "o_proj": "wo"}
DENSE = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}
EXPERT = {"gate": "router", "experts.gate_proj": "e_gate",
          "experts.up_proj": "e_up", "experts.down_proj": "e_down",
          "shared.gate_proj": "s_gate", "shared.up_proj": "s_up",
          "shared.down_proj": "s_down"}


def decoder_config(cfg: Dict[str, Any]):
    """The port's `DecoderConfig` of a DeepSeek-V2 `config.json` (with
    ``q_lora_rank`` null, the greedy softmax router of one group)."""
    from rag_application_tpu_torch.models.decoder import DecoderConfig

    if cfg.get("q_lora_rank") is not None:
        raise ValueError("q_lora_rank is not supported")
    if cfg.get("topk_method", "greedy") != "greedy" or cfg.get(
            "scoring_func", "softmax") != "softmax":
        raise ValueError("only the greedy softmax router is supported")
    s = cfg["serving"]
    rs = cfg.get("rope_scaling") or {}
    if rs and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs.get('type')!r}")
    return DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        dtype=s["dtype"], kv_quant=s["kv_int8"], attn_kernel=s["attn_kernel"],
        rope_kind="yarn" if rs else "none",
        rope_factor=float(rs.get("factor", 1.0)),
        rope_original_max_len=int(rs.get("original_max_position_embeddings",
                                         8192)),
        rope_beta_fast=float(rs.get("beta_fast", 32)),
        rope_beta_slow=float(rs.get("beta_slow", 1)),
        rope_mscale=float(rs.get("mscale", 1.0)),
        rope_mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_routed_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        norm_topk_prob=bool(cfg["norm_topk_prob"]),
        routed_scaling_factor=float(cfg["routed_scaling_factor"]))


def build_params(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The seed's weights in the port's stacked tree: each (leaf, layer)
    drawn on ``device``, quantized by the port (the router kept in bf16)
    and written into its layer's slot."""
    from rag_application_tpu_torch.models.decoder import (
        latent_shapes, quantize_decoder_params)

    dcfg = decoder_config(cfg)
    int8 = cfg["serving"]["weights_int8"]
    bf16 = torch.bfloat16
    params: Dict[str, Any] = {}
    for name, (shape, _) in latent_shapes(dcfg).items():
        if name in ("tok_emb", "lm_head"):
            continue
        if int8 and name != "router":
            params[name] = {
                "q": torch.empty(shape, dtype=torch.int8, device=device),
                "s": torch.empty(shape[:-2] + shape[-1:],
                                 dtype=torch.float32, device=device)}
        else:
            params[name] = torch.empty(shape, dtype=bf16, device=device)

    def put(name: str, i: int, w: torch.Tensor) -> None:
        if isinstance(params[name], dict):
            q = quantize_decoder_params({name: w})[name]
            params[name]["q"][i] = q["q"]
            params[name]["s"][i] = q["s"]
        else:
            params[name][i] = w

    for top, name in (("embed", "tok_emb"), ("lm_head", "lm_head")):
        w = ref.draw(seed, cfg, top, -1, device)
        params[name] = (quantize_decoder_params({name: w})[name] if int8
                        else w)
    Ld = cfg["first_k_dense_replace"]
    nh, dn = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    for i in range(cfg["num_hidden_layers"]):
        for leaf in ref.leaf_shapes(cfg, i):
            w = ref.draw(seed, cfg, leaf, i, device)
            if leaf == "kv_b_proj":  # a head's nope columns, then its v
                wh = w.view(w.shape[0], nh, -1)
                put("w_uk", i, wh[..., :dn].reshape(w.shape[0], -1))
                put("w_uv", i, wh[..., dn:].reshape(w.shape[0], -1))
            elif leaf in ATTN:
                put(ATTN[leaf], i, w)
            elif leaf in DENSE:
                put(DENSE[leaf], i, w)
            else:
                put(EXPERT[leaf], i - Ld, w)
            del w
    L, H, r = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["kv_lora_rank"]
    for name, shape in (("attn_norm", (L, H)), ("ffn_norm", (L, H)),
                        ("kva_norm", (L, r)), ("final_norm", (H,))):
        params[name] = torch.ones(shape, dtype=bf16, device=device)
    return params


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None):
    """One run of the cell. ``fault``, a test's hook, may break the
    batcher before the clients start (the run must then read not
    correct)."""
    cfg, mix = cell.config, cell.mix
    torch.set_grad_enabled(False)
    from rag_application_tpu_torch.llm.local import LocalLLM

    llm = LocalLLM(build_params(cfg, seed, device), decoder_config(cfg),
                   None, eos_id=cfg["eos_token_id"], device=device)
    b = mix["batcher"]
    batcher = llm.enable_batching(
        slots=b["slots"], prompt_pad=b["prompt_pad"], horizon=b["horizon"],
        chunk=b["chunk"], temperature=0.0)
    if fault is not None:
        fault(batcher)
    system = data.prompt_tokens(seed, 12, mix["system_tokens"],
                                cfg["vocab_size"])
    batcher.register_prefix(system)
    specs = data.request_mix(seed, mix["clients"], mix["per_client"], mix)
    (reqs, w0, w1, stats0, stats1, prof, t_trace, traced_steps,
     setup_s) = asyncio.run(gen._serve(cell, seed, seconds, trace, device,
                                       batcher, system, specs, t_start))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    done = [r for r in reqs if r.t_done is not None and w0 < r.t_done <= w1]
    sent = [r for r in reqs if w0 < r.t_submit <= w1]
    failed = sum(1 for r in sent if r.error is not None) + sum(
        1 for r in done if len(r.tokens) != r.new)
    delivered = sum(1 for r in reqs for t in r.times if w0 < t <= w1)
    window = w1 - w0
    first = [r.times[0] for r in sent if r.times and r.times[0] <= w1]
    ttft = [(r.times[0] if r.times and r.times[0] <= w1 else w1)
            - r.t_submit for r in sent]
    readings = harness.Readings(
        spans={"ttft": ttft},
        counters={k: stats1[k] - stats0[k] for k in ("steps", "tokens_out")},
        work=_work(cfg, mix, reqs, w0, w1, t_trace))
    if prof is not None:
        readings.trace = harness.Trace.from_profiler(
            prof, t_trace[1] - t_trace[0])

    del llm, batcher
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = gen.pick(seed, done, mix["judged_requests"])
    gap = judge(cfg, seed, sample, device)
    checks = [("served_logit_gap", gap, mix["limits"]["served_logit_gap"])]
    correct = failed == 0 and bool(done) and all(
        v <= lim for _, v, lim in checks)
    notes = {"window_s": window, "sent": len(sent), "done": len(done),
             "delivered": delivered, "ttft_n": len(ttft),
             "ttft_censored": len(ttft) - len(first),
             **readings.counters,
             "compactions": stats1.get("compactions", 0),
             "traced_s": t_trace[1] - t_trace[0],
             "traced_steps": traced_steps,
             "judged_tokens": [len(r.prompt) + len(r.tokens)
                               for r in sample],
             "errors": sorted({r.error for r in reqs if r.error})[:3]}
    return harness.Outcome({"gen_tokens_s": delivered / window}, readings,
                           checks, correct, len(sent), failed, peak, notes,
                           sample), setup_s


def _work(cfg, mix, reqs: List[gen.Request], w0: float, w1: float,
          t_trace) -> Dict[str, Any]:
    """The window's model operations (active parameters only: the 6
    routed and the shared experts, MLA's products as they run) of the
    tokens delivered in it and of the prompts first answered in it, the
    configuration's widths for the layer readers, and the visible context
    of each request live in the traced stretch with the decode kernel's
    geometry (one latent of kv_lora_rank + qk_rope_head_dim under every
    query head) for `decode_attn_roofline`."""
    p0 = mix["system_tokens"]
    flops = 0.0
    for r in reqs:
        plen = len(r.prompt)
        for j, t in enumerate(r.times):
            if w0 < t <= w1:
                flops += (roofline_moe.prefill_flops(cfg, p0, plen - p0)
                          if j == 0 else
                          roofline_moe.token_flops(cfg, plen + j - 1, True))
    mid = (t_trace[0] + t_trace[1]) / 2
    live = [len(r.prompt) + sum(1 for t in r.times if t <= mid)
            for r in reqs if r.times and r.times[0] <= mid
            and (r.t_done is None or r.t_done > mid)]
    return {"model_flops": flops, "window_s": w1 - w0,
            "deepseek": roofline_moe.widths(cfg), "live_context": live,
            "kv_heads": 1, "groups": cfg["num_attention_heads"],
            "head_dim": cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"],
            "traced": bool(t_trace[1])}


def judge(cfg, seed: int, sample: List[gen.Request], device,
          bits: int = 8) -> float:
    """The widest gap, over the sampled requests' served tokens, by which
    a served token's reference logit lies below the reference's best.
    With ``bits`` 4 the tokens judged are the ones the reference with
    int4 weights puts first instead (the control)."""
    if not sample:
        return float("inf")
    weights = ref.Weights(seed, cfg, device, bits=8)
    low = ref.Weights(seed, cfg, device, bits=bits) if bits != 8 else None
    gaps = ref.served_gaps_many(weights, [(r.prompt, r.tokens)
                                          for r in sample], other=low)
    return max(float(g.max()) for g in gaps)


def control_checks(cell: harness.Cell, seed: int, device,
                   seconds: float = 30.0):
    """The control's readings (benchmark/control.py): one program run,
    then its judged requests read with int4 weights in the reference."""
    outcome, _ = run(cell, seed, seconds, False, device, time.perf_counter())
    gap = judge(cell.config, seed, outcome.judged, device, bits=4)
    return [("served_logit_gap", gap,
             cell.mix["limits"]["served_logit_gap"])]
