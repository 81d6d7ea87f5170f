"""Fused T=1 GQA decode attention over the int8 KV cache.

Port of `rag_application_tpu/ops/decode_attn.py`. `decode_attend_int8`
is the kernel wrapper: on CUDA tensors it launches `csrc/decode_attn.cu`
(the port of the Pallas `_kernel`, a flash-decode split over the slot
axis with a merge step), on CPU tensors it runs
`decode_attend_int8_plain`. The reference's block-diagonal query and
diagonal extraction exist for the TPU's matrix lanes and have no
counterpart here: the kernel indexes each kv head directly.

Both versions keep the reference kernel's rounding points: the query in
bf16, dots and sums in f32, ``p * v_scale`` rounded to bf16 before the
product with the int8 V rows, and ``acc / max(l, 1e-30)``, so a row with
no visible slot gives 0 (the decoder's einsum path would give the mean
of V). The plain version takes the softmax in one pass; the kernel takes
it per slot chunk and merges, which moves the bf16 rounding of
``p * v_scale`` by the chunk's max: the two agree to bf16 rounding.

`pick_block` and `supported` make the JAX package's decisions, so both
packages gate the kernel on the same geometries and `generate` rounds
the slot axis to the same length. `kernel_fits` is the CUDA kernel's own
limit, the gate of the latent geometry the JAX package does not have:
absorbed multi-head latent attention (models/mla.py) is MQA, one kv
head of 576-wide keys (512 latent + 64 rope) under 16 query heads, with
its own softmax scale (``scale``) and the key's first 512 values as the
value (the same cache passed as ``ck`` and ``cv``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ..kernels import count_launch, launch, load, ptr

NEG = -1.0e30

_BLOCKS_TARGET = 4 * 132   # blocks to aim for: ~4 per SM of an H100
_MAX_SPLIT = 8             # chunks of S the merge kernel reads a head from
# shared memory a block may take so that 4 blocks share an SM's 228 KB
# (each block also holds 1 KB the system reserves), and the most one block
# may use
_SMEM_TARGET = 228 * 1024 // 4 - 1024
_SMEM_MAX = 227 * 1024


def pick_block(s: int) -> Optional[int]:
    """Largest supported S block that tiles the cache exactly."""
    for blk in (512, 256, 128, 64, 32):
        if s % blk == 0:
            return blk
    return None


def supported(*, seq_len: int, kv_heads: int, head_dim: int) -> bool:
    """Whether the fused kernel covers this cache geometry (callers
    fall back to the einsum path otherwise)."""
    return (kv_heads * head_dim) % 128 == 0 and pick_block(seq_len) is not None


def kernel_fits(*, seq_len: int, head_dim: int, q_groups: int) -> bool:
    """Whether the CUDA kernel takes this geometry by its own limits: S a
    multiple of 32, hd a multiple of 16 up to 1,024, and a 32-slot block
    within the shared memory one block may use."""
    return (seq_len % 32 == 0 and head_dim % 16 == 0 and head_dim <= 1024
            and _smem_bytes(q_groups, head_dim, 32) <= _SMEM_MAX)


def decode_attend_int8_plain(qg: torch.Tensor, ck: Dict[str, torch.Tensor],
                             cv: Dict[str, torch.Tensor],
                             mask: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract as
    `decode_attend_int8`; the softmax is taken in one pass."""
    hd = qg.shape[-1]
    q = qg[:, 0].to(torch.bfloat16).float()                   # (B,KVH,G,hd)
    raw = torch.einsum("bkgd,bskd->bkgs", q, ck["q"].float())
    sc = raw * ck["s"].transpose(1, 2)[:, :, None, :]
    sc = sc * (1.0 / math.sqrt(hd) if scale is None else scale)
    vis = mask[:, None, None, :]
    sc = torch.where(vis, sc, NEG)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m) * vis
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * cv["s"].transpose(1, 2)[:, :, None, :]).to(
        torch.bfloat16).float()
    acc = torch.einsum("bkgs,bskd->bkgd", pv, cv["q"].float())
    out = acc / torch.clamp(l, min=1e-30)
    return out[:, None].to(qg.dtype)


def _smem_bytes(q_groups: int, head_dim: int, chunk: int) -> int:
    """Shared memory of one kernel block (`smem_bytes` in
    csrc/decode_attn.cu): K and V rows as bf16 padded by 16 bytes, q rows
    as bf16 (the query heads padded to whole tiles of 8), bf16(p *
    v_scale) per padded head, the f32 score sheet, the scales, (max, sum)
    per head and the mask."""
    row = 2 * head_dim + 16
    heads = -(-q_groups // 8) * 8
    return (2 * chunk * row + heads * 2 * head_dim + heads * (2 * chunk + 16)
            + q_groups * (chunk + 4) * 4 + 2 * chunk * 4 + 2 * q_groups * 4
            + chunk)


def _pick_chunk(batch: int, kv_heads: int, q_groups: int, seq_len: int,
                head_dim: int) -> int:
    """Slots per thread block: the largest of 256/128/64/32 whose block
    leaves room for 4 on an SM, halved while the grid would leave the
    card's SMs short of blocks and S would still be cut into at most 8
    chunks (the merge reads a head's partials one after another, so a
    B = 1 call is better off with few long chunks). A geometry whose
    32-slot block exceeds the most a block may use raises."""
    def blocks(c):
        return batch * kv_heads * -(-seq_len // c)

    chunk = 256
    while chunk > 32 and (
            _smem_bytes(q_groups, head_dim, chunk) > _SMEM_TARGET
            or (blocks(chunk) < _BLOCKS_TARGET
                and -(-seq_len // (chunk // 2)) <= _MAX_SPLIT)):
        chunk //= 2
    if _smem_bytes(q_groups, head_dim, chunk) > _SMEM_MAX:
        raise ValueError(f"decode_attend_int8: G={q_groups} hd={head_dim} "
                         "exceeds the kernel's shared memory")
    return chunk


def resident_blocks(q_groups: int, head_dim: int, chunk: int) -> int:
    """Kernel blocks one SM of the current card holds at once at this
    geometry (CUDA's occupancy calculator); needs the card."""
    fn = load().decode_attn_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    n = fn(q_groups, head_dim, chunk)
    if n < 0:
        raise RuntimeError(f"decode_attn_blocks_per_sm failed: cudaError {-n}")
    return n


def decode_attend_int8(qg: torch.Tensor, ck: Dict[str, torch.Tensor],
                       cv: Dict[str, torch.Tensor],
                       mask: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Fused T=1 GQA attention against an int8 KV cache.

    qg   (B, 1, KVH, G, hd) bf16 — rope'd queries
    ck/cv {"q": (B, S, KVH, hd) int8, "s": (B, S, KVH) f32}
    mask (B, S) bool — slot visibility for the single query token
    scale  the scores' factor (default 1/sqrt(hd))
    returns (B, 1, KVH, G, hd) attention output, qg.dtype.

    Kernel wrapper: launches `csrc/decode_attn.cu` for CUDA tensors and
    runs `decode_attend_int8_plain` for CPU tensors. The kernel takes
    bf16 queries, S a multiple of 32 and hd a multiple of 16."""
    if qg.device.type == "cpu":
        return decode_attend_int8_plain(qg, ck, cv, mask, scale)
    if qg.device.type != "cuda":
        raise ValueError(f"decode_attend_int8: unsupported device {qg.device}")
    B, T, KVH, G, hd = qg.shape
    S = ck["q"].shape[1]
    if T != 1:
        raise ValueError("decode_attend_int8: one query token per row")
    if qg.dtype != torch.bfloat16:
        raise TypeError("decode_attend_int8: bf16 queries needed")
    for name, c in (("ck", ck), ("cv", cv)):
        if c["q"].dtype != torch.int8 or c["s"].dtype != torch.float32:
            raise TypeError(f"decode_attend_int8: {name} needs int8 rows "
                            "and f32 scales")
        if c["q"].shape != (B, S, KVH, hd) or c["s"].shape != (B, S, KVH):
            raise ValueError(f"decode_attend_int8: {name} shape mismatch")
        if not (c["q"].is_contiguous() and c["s"].is_contiguous()):
            raise ValueError(f"decode_attend_int8: {name} not contiguous")
        if c["q"].data_ptr() % 16:
            raise ValueError(f"decode_attend_int8: {name} rows not 16-byte "
                             "aligned")
    if mask.dtype != torch.bool or mask.shape != (B, S):
        raise ValueError("decode_attend_int8: mask must be (B, S) bool")
    if S % 32 or hd % 16 or hd > 1024:
        raise ValueError(f"decode_attend_int8: unsupported geometry S={S} "
                         f"hd={hd}")
    devs = {t.device for t in (qg, ck["q"], ck["s"], cv["q"], cv["s"], mask)}
    if len(devs) != 1:
        raise ValueError("decode_attend_int8: tensors on different devices")
    qg = qg.contiguous()
    if qg.data_ptr() % 16:  # the kernel reads q rows in 16-byte units
        qg = qg.clone()
    mask = mask.contiguous()
    chunk = _pick_chunk(B, KVH, G, S, hd)
    n_split = -(-S // chunk)
    part = (torch.empty(B * KVH * n_split * G * (hd + 2), dtype=torch.float32,
                        device=qg.device) if n_split > 1 else None)
    out = torch.empty_like(qg)
    launch("decode_attn_launch", qg.device, ptr(qg), ptr(ck["q"]),
           ptr(ck["s"]), ptr(cv["q"]), ptr(cv["s"]), ptr(mask), B, S, KVH, G,
           hd, chunk, 1.0 / math.sqrt(hd) if scale is None else float(scale),
           ptr(part), ptr(out))
    count_launch(decode_attend_int8)
    return out


decode_attend_int8.launches = 0
