"""LoRA fine-tuning for the decoder: rank-r adapters on the attention
projections, trained with the base frozen.

Port of `rag_application_tpu/models/lora.py`. The reference's local
generation quality is whatever checkpoint it downloads; this closes the
adaptation loop on the card: a base (optionally weight-only int8,
models/decoder.py) stays frozen while only the O(r * (in + out)) adapter
factors train, so the optimizer state is megabytes, not gigabytes.

  * adapters keep the decoder's STACKED-layer layout ((L, in, r) and
    (L, r, out)); `decoder._mm` recognizes the {"w", "a", "b", "s"} leaf
    and adds ``((x @ a) @ b) * s`` without forming the (in, out) product;
  * the base may be the int8 weight-only tree (QLoRA-style: frozen int8
    base + bf16 factors);
  * training takes gradients ONLY through the (a, b) factors: the
    optimizer sees a tree that is just the adapters.

`lora_merge` folds the factors back into plain matrices for serving one
adapter at no extra cost; `lora_banks` stacks several for per-row
serving through `decoder.forward(lora=...)`.

Over a tree sharded by `parallel/tp.py::shard_params`, `lora_init`
shards the factors it draws by the same rule (``a`` on its input
width, ``b`` on its output width), `lora_adapters` and `lora_apply`
keep the sharded leaves, and `make_lora_train_step` is the DP x TP step
(models/train.py). `lora_banks` and `save_adapters` gather sharded
factors to the merge device: serving banks are whole.

Random draws come from an explicit `torch.Generator` (the reference's
PRNG key): `lora_init` draws the same law as the reference, not the same
numbers. The ``save_adapters`` npz is the reference's format ("{t}.a",
"{t}.b" and an optional "{t}.s", as float32), so adapters cross the two
packages both ways.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..parallel import tp
from ..utils import DeviceLike, resolve_device
from .decoder import DecoderConfig
from .train import TrainState, _apply_update, lm_loss

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def _base(w: Any) -> torch.Tensor:
    """Dense float32 view of a (possibly quantized) base matmul weight.
    Quantized leaves carry one scale per OUTPUT channel: q (L, in, out),
    s (L, out)."""
    if isinstance(w, dict):  # {"q","s"} weight-only int8
        return w["q"].float() * w["s"][..., None, :].float()
    return w.float()


def lora_init(generator: torch.Generator, params: Dict[str, Any], *,
              r: int = 8, alpha: float = 16.0,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Dict[str, Any]:
    """Wrap each target projection as {"w": base, "a", "b", "s"}.

    a ~ N(0, 1/in) in bf16 from ``generator`` (which must live on the
    params' device), b = 0: the wrapped model computes EXACTLY the base
    model at init. s = alpha / r in an (L, 1, 1) float32 leaf. Over a
    sharded base the factors are drawn on the merge device and sharded on
    the base's mesh."""
    out = dict(params)
    for name in targets:
        w = params[name]
        leaf = w["q"] if isinstance(w, dict) else w
        L, fan_in, fan_out = leaf.shape
        dev = leaf.device
        a = (torch.randn((L, fan_in, r), generator=generator,
                         dtype=torch.float32, device=dev)
             / np.sqrt(fan_in)).to(torch.bfloat16)
        b = torch.zeros((L, r, fan_out), dtype=torch.bfloat16, device=dev)
        s = torch.full((L, 1, 1), alpha / r, dtype=torch.float32, device=dev)
        factors = {"a": a, "b": b, "s": s}
        if isinstance(leaf, tp.Sharded):
            factors = tp.shard_params(leaf.mesh, factors)
        out[name] = {"w": w, **factors}
    return out


def lora_adapters(params: Dict[str, Any]) -> Dict[str, Any]:
    """The trainable sub-tree: {name: {"a", "b"}} for wrapped leaves."""
    return {name: {"a": w["a"], "b": w["b"]}
            for name, w in params.items()
            if isinstance(w, dict) and "a" in w}


def lora_apply(params: Dict[str, Any],
               adapters: Dict[str, Any]) -> Dict[str, Any]:
    """Graft adapter factors back onto the wrapped tree (a new dict; the
    tensors are shared)."""
    out = dict(params)
    for name, ab in adapters.items():
        out[name] = {**params[name], "a": ab["a"], "b": ab["b"]}
    return out


def lora_merge(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold every adapter into a plain dense matrix (w + a @ b * s,
    computed in float32). The merged matrix takes the base's dtype;
    int8 bases fold to bf16 (re-quantize with quantize_decoder_params)."""
    out = {}
    with torch.no_grad():
        for name, w in params.items():
            if isinstance(w, dict) and "a" in w:
                merged = (_base(w["w"])
                          + (w["a"].float() @ w["b"].float()) * w["s"])
                ref = w["w"]["q"] if isinstance(w["w"], dict) else w["w"]
                dt = ref.dtype if ref.dtype != torch.int8 else torch.bfloat16
                out[name] = merged.to(dt)
            else:
                out[name] = w
    return out


def lora_wrap_with(params: Dict[str, Any], adapters: Dict[str, Any], *,
                   alpha: float = 16.0) -> Dict[str, Any]:
    """Wrap a base tree with ALREADY-TRAINED factors (e.g. from
    `load_adapters`); the rank comes from the factor shapes. A scale
    embedded in the artifact wins over the ``alpha`` fallback."""
    out = dict(params)
    for name, ab in adapters.items():
        L, _, r = ab["a"].shape
        s = ab.get("s")
        if s is None:
            s = torch.full((L, 1, 1), alpha / r, dtype=torch.float32,
                           device=ab["a"].device)
        out[name] = {"w": params[name], "a": ab["a"], "b": ab["b"], "s": s}
    return out


def lora_banks(adapter_trees: Sequence[Dict[str, Any]], *,
               alpha: float = 16.0, dtype: torch.dtype = torch.bfloat16
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Stack N adapter artifacts into per-row-selectable serving banks.

    Input: `load_adapters`-shaped trees ({target: {"a": (L, in, r_i),
    "b": (L, r_i, out), optional "s": (L, 1, 1)}}). Output: {target:
    {"a": (L, N+1, in, R), "b": (L, N+1, R, out)}} in ``dtype`` on the
    factors' device, where R is the largest rank (shorter adapters
    zero-pad: zero columns are exact no-ops) and index 0 is the ZERO
    adapter, the base model. Each adapter's scale (or the alpha / r
    fallback) folds into its "b" factors, so serving applies x @ a @ b."""
    adapter_trees = [tp.gather_params(tree) for tree in adapter_trees]
    names = sorted({t for tree in adapter_trees for t in tree})
    if not names:
        return {}
    rmax = max(tree[t]["a"].shape[-1]
               for tree in adapter_trees for t in tree)
    targets: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.no_grad():
        for t in names:
            a_rows, b_rows = [], []
            for tree in adapter_trees:
                ab = tree.get(t)
                if ab is None:
                    a_rows.append(None)
                    b_rows.append(None)
                    continue
                L, fan_in, r = ab["a"].shape
                fan_out = ab["b"].shape[-1]
                dev = ab["a"].device
                s = ab.get("s")
                if s is None:
                    s = torch.full((L, 1, 1), alpha / r,
                                   dtype=torch.float32, device=dev)
                a = torch.zeros((L, fan_in, rmax), dtype=dtype, device=dev)
                a[:, :, :r] = ab["a"].to(dtype)
                b = torch.zeros((L, rmax, fan_out), dtype=dtype, device=dev)
                b[:, :r, :] = (ab["b"].float() * s.float()).to(dtype)
                a_rows.append(a)
                b_rows.append(b)
            za = torch.zeros_like(next(x for x in a_rows if x is not None))
            zb = torch.zeros_like(next(x for x in b_rows if x is not None))
            targets[t] = {
                "a": torch.stack([za] + [za if a is None else a
                                         for a in a_rows], dim=1),
                "b": torch.stack([zb] + [zb if b is None else b
                                         for b in b_rows], dim=1)}
    return targets


def save_adapters(adapters: Dict[str, Any], path: str, *,
                  wrapped: Dict[str, Any] = None) -> None:
    """npz of the adapter factors alone, as float32 — the artifact a
    fine-tune ships. Pass the ``wrapped`` tree to embed each target's
    trained scale s, so a loader need not know the training alpha."""
    adapters = tp.gather_params(adapters)
    wrapped = None if wrapped is None else tp.gather_params(wrapped)
    flat = {}
    for name, ab in adapters.items():
        flat[f"{name}.a"] = ab["a"].detach().float().cpu().numpy()
        flat[f"{name}.b"] = ab["b"].detach().float().cpu().numpy()
        if wrapped is not None and isinstance(wrapped.get(name), dict):
            flat[f"{name}.s"] = wrapped[name]["s"].detach().float().cpu(
            ).numpy()
    np.savez(path, **flat)


def load_adapters(path: str, dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Inverse of save_adapters (either package's files): factors in
    ``dtype``, scales float32, on ``device`` (default: cuda). Graft with
    `lora_apply` (training) or `lora_wrap_with` (serving)."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    with np.load(path) as raw:
        for key in raw.files:
            name, part = key.rsplit(".", 1)
            dt = torch.float32 if part == "s" else dtype
            out.setdefault(name, {})[part] = torch.from_numpy(
                np.ascontiguousarray(raw[key], np.float32)).to(dev).to(dt)
    return out


def make_lora_train_step(cfg: DecoderConfig, optimizer, *,
                         remat: bool = True) -> Callable:
    """Causal-LM step that differentiates ONLY the adapter factors.

    state.params holds just the adapters (`init_train_state` over
    `lora_adapters(wrapped)`); the frozen wrapped tree is an explicit
    argument: step(state, frozen_params, batch) -> (state, metrics).
    The base and the scales are never written."""

    def train_step(state: TrainState, frozen: Dict[str, Any], batch
                   ) -> Tuple[TrainState, dict]:
        params = lora_apply(frozen, state.params)
        loss, acc = lm_loss(params, cfg, batch, remat=remat)
        _apply_update(state, loss)
        return (TrainState(state.params, state.opt_state, state.step + 1),
                {"loss": loss.detach(), "accuracy": acc})

    return train_step
