"""Routed experts as grouped products, on the device with no host read.

Replaces no kernel of the JAX package (it has no expert layer): it is the
expert layer of DeepSeek-style mixture-of-experts decoders
(models/moe.py). Each token has chosen ``k`` of ``E`` experts; every
(token, expert) pair is computed, none dropped. `moe_experts` computes

    y[t] = sum_j w[t, j] * E_{ids[t, j]}(x[t])
    E_e(x) = down_e(silu(gate_e(x)) * up_e(x))     (SwiGLU)

with int8 expert weights (one f32 scale per output channel) read as bf16
exactly. The rounding points, in both versions: the products' sums in
f32; ``g = bf16(acc_g * s_g)``, ``u = bf16(acc_u * s_u)``, ``a =
bf16(silu(g) * u)`` (silu and the product in f32), ``y_e = bf16(acc_d *
s_d)``; the weighted sum of a token's ``k`` outputs in f32, in pair
order, then cast to x's type.

Layout (`align`): the pairs sorted by expert, each expert's run padded to
a whole number of ``block`` rows, in a buffer of the static length
``P + E * (block - 1)`` rounded up to a whole block (``P = T * k``), so
no length is read back to the host. Each block of rows belongs to one
expert (``block_expert``, -1 for blocks past the last expert's run); pad
rows name the pair ``P`` and compute zeros. The decode loop dispatches
its steps without waiting on the card (llm/scheduler.py), which this
keeps: sorting, counting and placing run as device ops (`scatter_add_`,
`argsort`, `searchsorted`), never `bincount`, `nonzero` or `.item()`.

On the card the two products are CUDA kernels (`csrc/moe_experts.cu`):
one block of rows and 64 columns a block, the expert's int8 tile
converted to bf16 once, in shared memory, before mma.sync; the gate and
up products and the SwiGLU fused in the first, the down product in the
second; the k outputs of a token are gathered and summed by torch. What
bounds them: at a decode step (64 tokens x 6 pairs over 64 experts)
bytes, nearly every expert's 8.65 MB of int8 codes; at a prefill of
thousands of tokens the products (~300 rows an expert). On the CPU,
`moe_experts_plain` runs the same layout expert by expert (reading each
run's bounds on the host).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import count_launch, launch, ptr


def block_rows(pairs: int) -> int:
    """Rows of a block: 16 (one mma tile) while the pairs are few
    (decode: each expert sees a few tokens), 64 for a prefill."""
    return 16 if pairs <= 4096 else 64


def align(ids: torch.Tensor, n_experts: int, block: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pairs ``ids`` (T, k) in expert-sorted, block-padded order.

    Returns (sorted_pair (Pp,), block_expert (Pp / block,), pair_pos (P,),
    counts (E,)): the pair index at each padded row (``P`` at pad rows),
    the expert of each block (-1 past the end), each pair's padded row,
    and the pairs each expert received. Device ops only."""
    flat = ids.reshape(-1).long()
    P = flat.shape[0]
    dev = flat.device
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    padded = (counts + (block - 1)) // block * block
    pend = torch.cumsum(padded, 0)
    pstart = pend - padded
    cstart = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat, stable=True)
    sorted_e = flat.index_select(0, order)
    rank = torch.arange(P, device=dev) - cstart.index_select(0, sorted_e)
    dest = pstart.index_select(0, sorted_e) + rank
    rows = -(-(P + n_experts * (block - 1)) // block) * block
    sorted_pair = torch.full((rows,), P, dtype=torch.long, device=dev)
    sorted_pair.scatter_(0, dest, order)
    pair_pos = torch.empty(P, dtype=torch.long, device=dev)
    pair_pos.scatter_(0, order, dest)
    starts = torch.arange(0, rows, block, device=dev)
    bexp = torch.searchsorted(pend, starts, right=True)
    bexp = torch.where(bexp < n_experts, bexp, -1)
    return sorted_pair, bexp, pair_pos, counts


def _codes(w: Any) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(weights, scale): an int8 {"q", "s"} pair or a float tensor."""
    if isinstance(w, dict):
        return w["q"], w["s"]
    return w, None


def _product(a: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
             dt: torch.dtype) -> torch.Tensor:
    """dt(f32(a @ w) * s): the kernels' product and rounding point."""
    acc = a.float() @ w.float()
    if s is not None:
        acc = acc * s.float()
    return acc.to(dt)


def _swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (F.silu(g.float()) * u.float()).to(g.dtype)


def _combine(y: torch.Tensor, pair_pos: torch.Tensor, w: torch.Tensor,
             dt: torch.dtype) -> torch.Tensor:
    """Each token's k expert outputs, weighted and summed in f32."""
    T, k = w.shape
    yk = y.index_select(0, pair_pos).view(T, k, -1).float()
    return (yk * w.float()[..., None]).sum(dim=1).to(dt)


def moe_experts_plain(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                      w_gate: Any, w_up: Any, w_down: Any) -> torch.Tensor:
    """Plain PyTorch version of `moe_experts`: the same layout and
    rounding points, one expert's run of rows at a time."""
    T, k = ids.shape
    gq, gs = _codes(w_gate)
    uq, us = _codes(w_up)
    dq, ds = _codes(w_down)
    E = gq.shape[0]
    block = block_rows(T * k)
    sorted_pair, bexp, pair_pos, counts = align(ids, E, block)
    rows = sorted_pair.shape[0]
    tok = torch.where(sorted_pair < T * k, sorted_pair // k, T)
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))]).index_select(0, tok)
    y = x.new_zeros((rows, dq.shape[-1]))
    padded = ((counts + (block - 1)) // block * block).tolist()
    start = 0
    for e, n in enumerate(padded):
        if n:
            r = slice(start, start + n)
            a = _swiglu(_product(xp[r], gq[e], None if gs is None else gs[e],
                                 x.dtype),
                        _product(xp[r], uq[e], None if us is None else us[e],
                                 x.dtype))
            y[r] = _product(a, dq[e], None if ds is None else ds[e], x.dtype)
        start += n
    return _combine(y, pair_pos, w, x.dtype)


def _check(name: str, w: Any, E: int, K: int, N: int, dev) -> None:
    if not isinstance(w, dict):
        raise TypeError(f"moe_experts: {name} needs int8 codes and f32 "
                        "scales on the card, not a float weight")
    q, s = w["q"], w["s"]
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"moe_experts: {name} needs int8 codes and f32 "
                        "scales")
    if q.shape != (E, K, N) or s.shape != (E, N):
        raise ValueError(f"moe_experts: {name} shape {tuple(q.shape)}, "
                         f"want {(E, K, N)}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"moe_experts: {name} not contiguous")
    if q.device != dev or s.device != dev:
        raise ValueError(f"moe_experts: {name} on another device")
    if q.data_ptr() % 16:
        raise ValueError(f"moe_experts: {name} codes not 16-byte aligned")


def check_kernel_inputs(x: torch.Tensor, ids: torch.Tensor, w_gate: Any,
                        w_up: Any, w_down: Any) -> Tuple[int, int, int]:
    """(E, H, F) of the kernel's operands, or the TypeError / ValueError
    that refuses them: bf16 x (T, H), int8 expert weights with f32 scales,
    widths that are multiples of 64, all on x's device."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"moe_experts: bf16 activations needed on the "
                        f"card, got {x.dtype}")
    if not isinstance(w_gate, dict):
        raise TypeError("moe_experts: w_gate needs int8 codes and f32 "
                        "scales on the card, not a float weight")
    E, H, Fw = w_gate["q"].shape
    dev = x.device
    if x.dim() != 2 or x.shape != (ids.shape[0], H):
        raise ValueError(f"moe_experts: x {tuple(x.shape)}, want "
                         f"{(ids.shape[0], H)}")
    for name, wt, K, N in (("w_gate", w_gate, H, Fw), ("w_up", w_up, H, Fw),
                           ("w_down", w_down, Fw, H)):
        _check(name, wt, E, K, N, dev)
    if H % 64 or Fw % 64:
        raise ValueError(f"moe_experts: widths {H}, {Fw} not multiples "
                         "of 64")
    return E, H, Fw


def moe_experts(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                w_gate: Any, w_up: Any, w_down: Any) -> torch.Tensor:
    """Routed SwiGLU experts over every (token, expert) pair.

    x (T, H) activations; ids (T, k) the experts each token chose; w (T,
    k) their weights (f32); w_gate, w_up {"q": (E, H, F) int8, "s": (E,
    F) f32} and w_down {"q": (E, F, H), "s": (E, H)} (or, on the CPU,
    float tensors of those shapes). Returns (T, H) in x's type.

    Kernel wrapper: on the CPU it runs `moe_experts_plain`; on the card
    it launches `csrc/moe_experts.cu` and refuses (`check_kernel_inputs`)
    what the kernels do not take, rather than leave the device path."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, ids, w, w_gate, w_up, w_down)
    T, k = ids.shape
    E, H, Fw = check_kernel_inputs(x, ids, w_gate, w_up, w_down)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    BM = block_rows(T * k)
    sorted_pair, bexp, pair_pos, _ = align(ids, E, BM)
    rows = sorted_pair.shape[0]
    dev = x.device
    h = torch.empty((rows, Fw), dtype=torch.bfloat16, device=dev)
    y = torch.empty((rows, H), dtype=torch.bfloat16, device=dev)
    launch("moe_experts_launch", dev, ptr(x), x.stride(0), ptr(sorted_pair),
           T * k, k, ptr(bexp), rows // BM, BM, H, Fw, ptr(w_gate["q"]),
           ptr(w_gate["s"]), ptr(w_up["q"]), ptr(w_up["s"]),
           ptr(w_down["q"]), ptr(w_down["s"]), ptr(h), ptr(y))
    count_launch(moe_experts)
    return _combine(y, pair_pos, w, x.dtype)


moe_experts.launches = 0
