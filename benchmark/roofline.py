"""Published peaks of one NVIDIA H100 SXM and the operations and bytes of
each kernel's work, counted from shapes.

The counts say what the work needs, whatever kernel does it: each input
byte read once, each output byte written once, and a product of two
(m, k) x (k, n) operands as 2mnk operations. A roofline share is the
least time the chip could take (the larger of operations over the peak
rate and bytes over the memory bandwidth) over the time measured.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_INT8_OPS = 1.979e15
PEAK_BF16_FLOPS = 0.989e15
PEAK_TF32_FLOPS = 0.495e15
PEAK_F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(work: Tuple[float, float], peak_ops: float) -> float:
    """Least time for ``work`` = (operations, bytes): the operations at
    ``peak_ops`` or the bytes at HBM speed, whichever takes longer."""
    ops, nbytes = work
    return max(ops / peak_ops, nbytes / HBM_BYTES_S)


def scan_int8(queries: int, rows: int, dim: int) -> Tuple[float, float]:
    """The int8 corpus scan: (operations, bytes). Reads the int8 corpus
    and queries once; writes one (score, id) pair a 128-row bin."""
    ops = 2.0 * queries * rows * dim
    nbytes = rows * dim + queries * dim + 8.0 * queries * (rows / 128.0)
    return ops, nbytes


def scan_bf16_prefix(queries: int, rows: int,
                     prefix: int) -> Tuple[float, float]:
    """The cascade's bf16 scan over the first ``prefix`` columns:
    (operations, bytes)."""
    ops = 2.0 * queries * rows * prefix
    nbytes = 2.0 * rows * prefix + 2.0 * queries * prefix \
        + 4.0 * rows + 8.0 * queries * (rows / 128.0)
    return ops, nbytes


def scan_bound_s(queries: int, rows: int, dim: int, prefix: int) -> float:
    """Least time of one batch's scans: the int8 scan at the int8 peak
    plus, with ``prefix`` > 0, the bf16 prefix scan at the bf16 peak."""
    t = bound_s(scan_int8(queries, rows, dim), PEAK_INT8_OPS)
    if prefix:
        t += bound_s(scan_bf16_prefix(queries, rows, prefix),
                     PEAK_BF16_FLOPS)
    return t


def decode_attn_bytes(rows_ctx: Iterable[int], kv_heads: int, groups: int,
                      head_dim: int) -> float:
    """One int8-KV decode-attention call over rows of the given visible
    context lengths: int8 K and V and their f32 scales of each visible
    slot, the slot mask of each visible slot, bf16 q and bf16 out."""
    ctx = list(rows_ctx)
    slots = float(sum(ctx))
    kv = slots * kv_heads * (2.0 * head_dim + 2 * 4.0)
    mask = slots
    qo = len(ctx) * kv_heads * groups * head_dim * 2.0 * 2
    return kv + mask + qo


def decoder_token_flops(cfg: Dict, context: int, head: bool) -> float:
    """Model operations of one token at position ``context`` (it attends
    over context + 1 slots): every projection, attention's two products
    and, with ``head``, the output head."""
    L, H, M = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["intermediate_size"]
    nq, nkv, hd, V = cfg["num_attention_heads"], \
        cfg["num_key_value_heads"], cfg["head_dim"], cfg["vocab_size"]
    proj = H * nq * hd + 2 * H * nkv * hd + nq * hd * H + 3 * H * M
    attn = 2 * nq * hd * (context + 1)
    return 2.0 * L * (proj + attn) + (2.0 * H * V if head else 0.0)


def prefill_flops(cfg: Dict, start: int, tokens: int) -> float:
    """Model operations of a prefill of ``tokens`` tokens at positions
    start .. start + tokens - 1; the output head only on the last."""
    L, nq, hd = cfg["num_hidden_layers"], cfg["num_attention_heads"], \
        cfg["head_dim"]
    base = decoder_token_flops(cfg, 0, False) - 2.0 * L * 2 * nq * hd
    # sum over positions p of the attention term 2 L * 2 nq hd (p + 1)
    span = tokens * start + tokens * (tokens + 1) / 2.0
    attn = 2.0 * L * 2 * nq * hd * span
    head = decoder_token_flops(cfg, 0, True) - decoder_token_flops(
        cfg, 0, False)
    return tokens * base + attn + head
