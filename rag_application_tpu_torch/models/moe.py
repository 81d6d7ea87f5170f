"""DeepSeek-V2's expert layer (`DeepseekV2MoE` with the greedy top-k
gate): a router over the routed experts, every chosen (token, expert)
pair computed, and shared experts every token passes through.

    logits = f32(h) @ f32(router)            (router kept in bf16)
    w, ids = top-k(softmax(logits))          (greedy; w renormalized only
                                              with `norm_topk_prob`)
    y = sum_j (w_j * routed_scaling_factor) E_{ids_j}(h) + S(h)

Each E is a SwiGLU of width `moe_intermediate_size`; the shared experts
are one SwiGLU of width n_shared * moe_intermediate_size (the module's
own concatenation). The routed products run in ops/moe.py, on the device
with no host read, so a decode chunk's steps still dispatch without
waiting on the card.

Counters: `routed_pairs()` (a host count) and `experts_hit()` (distinct
experts reached, summed over the layer calls, accumulated on the device).
The batcher's `stats()` reads the latter without waiting on the card: a
copy into pinned memory is queued behind the work, and a read returns
the newest copy the card has finished (`wait=True` waits for the
current one). Both also feed `METRICS` as ``moe_routed_pairs`` and
``moe_experts_hit``. `layer` returns its call's count of experts reached
as a device scalar too, which the decoder hangs on its ``model.moe``
span for the readers to read after the run.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops import moe as _moe
from ..utils.observability import METRICS
from .decoder import DecoderConfig, _mm_one

_lock = threading.Lock()
_ROUTED = [0]
# per device: the accumulator, and its newest copy on the host (pinned
# memory, the event that marks the copy done, the value last read)
_HITS: Dict[torch.device, torch.Tensor] = {}
_COPIES: Dict[torch.device, list] = {}
_HITS_PUSHED = [0]


def _hits_on(device: torch.device) -> torch.Tensor:
    t = _HITS.get(device)
    if t is None:
        with _lock:
            t = _HITS.setdefault(device, torch.zeros(
                (), dtype=torch.long, device=device))
    return t


def routed_pairs() -> int:
    """(token, expert) pairs routed since the process started."""
    return _ROUTED[0]


def _read(dev: torch.device, acc: torch.Tensor, wait: bool) -> int:
    if dev.type != "cuda":
        return int(acc)
    c = _COPIES.get(dev)
    if c is None:
        c = _COPIES[dev] = [torch.zeros((), dtype=torch.long,
                                        pin_memory=True), None, 0]
    host, ev, _ = c
    if ev is not None and (wait or ev.query()):
        ev.synchronize()
        c[2], c[1] = int(host), None
    if c[1] is None:  # queue the next copy behind the work so far
        with torch.cuda.device(dev):
            host.copy_(acc, non_blocking=True)
            c[1] = torch.cuda.Event()
            c[1].record()
        if wait:
            c[1].synchronize()
            c[2], c[1] = int(host), None
    return c[2]


def experts_hit(wait: bool = False) -> int:
    """Distinct experts reached by each expert-layer call, summed over
    the calls since the process started, as of the newest copy the card
    has finished (on the CPU, now); ``wait`` waits for all work so far."""
    with _lock:
        total = sum(_read(d, t, wait) for d, t in list(_HITS.items()))
        new, _HITS_PUSHED[0] = total - _HITS_PUSHED[0], max(
            total, _HITS_PUSHED[0])
    if new > 0:
        METRICS.inc("moe_experts_hit", new)
    return total


def count(pairs: int) -> None:
    """Count a layer call's routed pairs (host side, once a call: the
    decoder calls it outside any captured graph)."""
    with _lock:
        _ROUTED[0] += pairs
    METRICS.inc("moe_routed_pairs", pairs)


def router(h: torch.Tensor, w: Any, cfg: DecoderConfig):
    """(weights (N, k) f32, expert ids (N, k)) of the rows of h (N, H)."""
    logits = h.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    wts, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        wts = wts / (wts.sum(dim=-1, keepdim=True) + 1e-20)
    if cfg.routed_scaling_factor != 1.0:
        wts = wts * cfg.routed_scaling_factor
    return wts, ids


def swiglu(h: torch.Tensor, gate: Any, up: Any, down: Any) -> torch.Tensor:
    """down(silu(h gate) * (h up)), the decoder's dense MLP."""
    return _mm_one(F.silu(_mm_one(h, gate)) * _mm_one(h, up), down)


def layer(h: torch.Tensor, lp: Dict[str, Any], cfg: DecoderConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer's output for h (B, T, H), routed plus shared,
    and the number of distinct experts the call reached (a device
    scalar, also added to the device accumulator). Device work only: the
    caller counts the pairs (`count`)."""
    B, T, H = h.shape
    x = h.reshape(B * T, H)
    wts, ids = router(x, lp["router"], cfg)
    reached = torch.zeros(cfg.n_routed_experts, dtype=torch.long,
                          device=x.device)
    hit = reached.scatter_(0, ids.reshape(-1), 1).sum()
    _hits_on(x.device).add_(hit)
    routed = _moe.moe_experts(x, ids, wts, lp["e_gate"], lp["e_up"],
                              lp["e_down"])
    if "s_gate" in lp:
        routed = routed + swiglu(x, lp["s_gate"], lp["s_up"], lp["s_down"])
    return routed.view(B, T, H), hit
