"""Operations and bytes of a DeepSeek-V2 decoder's work, counted from
shapes (the rules of benchmark/roofline.py: each input byte read once,
each output byte written once, a (m, k) x (k, n) product 2mnk
operations), for `gen_mfu` and the expert and latent-attention readers.

Model operations count active parameters only: each token's 6 routed
experts, the shared experts and the router, and multi-head latent
attention's products as they run: a prefill expands every slot's latent
to K and V (W_uk, W_uv) and attends at MHA (192-wide scores, 128-wide
values); a decode step absorbs W_uk into the query and W_uv into the
output and attends over the latents (576-wide scores, 512-wide values).
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.roofline import HBM_BYTES_S, PEAK_BF16_FLOPS, bound_s

__all__ = ["HBM_BYTES_S", "PEAK_BF16_FLOPS", "bound_s", "widths",
           "token_flops", "prefill_flops", "moe_work", "mla_decode_work"]


def widths(cfg: Dict) -> Dict[str, int]:
    """The widths the counts need, from a DeepSeek-V2 `config.json`."""
    return {"H": cfg["hidden_size"], "L": cfg["num_hidden_layers"],
            "V": cfg["vocab_size"], "nh": cfg["num_attention_heads"],
            "r": cfg["kv_lora_rank"], "dn": cfg["qk_nope_head_dim"],
            "dr": cfg["qk_rope_head_dim"], "dv": cfg["v_head_dim"],
            "M": cfg["intermediate_size"], "Ld": cfg["first_k_dense_replace"],
            "E": cfg["n_routed_experts"], "k": cfg["num_experts_per_tok"],
            "F": cfg["moe_intermediate_size"],
            "Fs": cfg["n_shared_experts"] * cfg["moe_intermediate_size"]}


def _mlp_macs(w: Dict[str, int]) -> float:
    """Multiply-adds of one token's MLPs over every layer: the dense
    SwiGLU in the leading layers; router, k routed and the shared
    experts in the others."""
    dense = w["Ld"] * 3 * w["H"] * w["M"]
    expert = (w["L"] - w["Ld"]) * (w["H"] * w["E"] + 3 * w["H"] * w["F"]
                                   * w["k"] + 3 * w["H"] * w["Fs"])
    return float(dense + expert)


def _proj_macs(w: Dict[str, int]) -> float:
    """Multiply-adds of one token's attention projections a layer:
    W_q, W_kva and W_o."""
    return float(w["H"] * w["nh"] * (w["dn"] + w["dr"])
                 + w["H"] * (w["r"] + w["dr"]) + w["nh"] * w["dv"] * w["H"])


def token_flops(cfg: Dict, context: int, head: bool) -> float:
    """Operations of one decode token at position ``context`` (it attends
    over context + 1 latents), absorbed: the projections, q's W_uk, the
    scores (latent + rope wide) and the weighted latents (latent wide),
    W_uv; the MLPs; with ``head`` the output head."""
    w = widths(cfg)
    nh, r = w["nh"], w["r"]
    absorb = nh * w["dn"] * r + nh * r * w["dv"]
    attn = nh * (r + w["dr"] + r) * (context + 1)
    per_layer = _proj_macs(w) + absorb + attn
    return 2.0 * (w["L"] * per_layer + _mlp_macs(w)) + (
        2.0 * w["H"] * w["V"] if head else 0.0)


def prefill_flops(cfg: Dict, start: int, tokens: int) -> float:
    """Operations of a prefill of ``tokens`` tokens at positions start ..
    start + tokens - 1 after a cached prefix of ``start``, expanded:
    each token's projections and MLPs, every slot's latent expanded to
    K and V, the scores (nope + rope wide) and values over each query's
    visible slots; the output head on the last token."""
    w = widths(cfg)
    nh, r = w["nh"], w["r"]
    slots = start + tokens
    expand = slots * r * nh * (w["dn"] + w["dv"])
    span = tokens * start + tokens * (tokens + 1) / 2.0  # sum of p + 1
    attn = nh * (w["dn"] + w["dr"] + w["dv"]) * span
    per_token = w["L"] * _proj_macs(w) + _mlp_macs(w)
    return 2.0 * (tokens * per_token + w["L"] * (expand + attn)) + (
        2.0 * w["H"] * w["V"])


def moe_work(w: Dict[str, int], tokens: int,
             experts_hit: int) -> Tuple[float, float]:
    """One expert layer's call over ``tokens`` tokens that reached
    ``experts_hit`` distinct routed experts: (operations, bytes). Bytes:
    the int8 codes and f32 scales of the experts reached, of the shared
    experts, the bf16 router, and the bf16 activations in and out."""
    H, F, Fs, E, k = w["H"], w["F"], w["Fs"], w["E"], w["k"]
    ops = 2.0 * tokens * (k * 3 * H * F + 3 * H * Fs + H * E)
    expert_bytes = 3 * H * F + 4.0 * (2 * F + H)
    shared_bytes = 3 * H * Fs + 4.0 * (2 * Fs + H) if Fs else 0.0
    nbytes = (experts_hit * expert_bytes + shared_bytes + 2.0 * H * E
              + 2.0 * 2 * tokens * H)
    return ops, nbytes


def mla_decode_work(w: Dict[str, int], tokens: int,
                    slots: int) -> Tuple[float, float]:
    """One absorbed decode attention call over ``tokens`` rows that see
    ``slots`` latents in all: (operations, bytes). Bytes: each visible
    latent (int8 codes and its f32 scale) read once, W_uk and W_uv
    (int8 codes, f32 scales), q (nope and rope, bf16) in, out (bf16)."""
    nh, r, dn, dr, dv = w["nh"], w["r"], w["dn"], w["dr"], w["dv"]
    ops = 2.0 * (tokens * nh * (dn * r + r * dv)
                 + slots * nh * (r + dr + r))
    nbytes = (slots * (r + dr + 4.0) + r * nh * (dn + dv)
              + 4.0 * nh * (dn + dv) + tokens * nh * (dn + dr + dv) * 2.0)
    return ops, nbytes
