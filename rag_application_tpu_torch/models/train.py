"""Encoder and decoder training: contrastive fine-tuning and causal-LM
steps, in PyTorch.

Port of `rag_application_tpu/models/train.py`. The reference has no
training loop of its own upstream: its embedding quality is whatever the
remote model serves. This module fine-tunes the encoder on the user's
own corpus with the standard recipe — InfoNCE over in-batch negatives
(both directions), optionally at every matryoshka prefix — and trains
the decoder on next-token cross-entropy.

The step functions keep the reference's call shape, ``train_step(state,
batch) -> (state, metrics)``, over eager autograd:

  * `TrainState` holds the trainable tensors (leaves with
    ``requires_grad``), the optimizer and the step count. A step updates
    the tensors and the optimizer's moments IN PLACE and returns a state
    holding the same objects (optax returns new arrays); `init_train_state`
    makes the trainable copies, so the tensors a model serves from are
    never the ones a step moves.
  * `make_optimizer` is `torch.optim.AdamW` behind optax's ``init``:
    the same math as ``optax.adamw`` — bias-corrected moments, eps 1e-8
    outside the square root, decay decoupled and applied to every leaf
    from the parameter before the update. The moments live in each
    parameter's dtype, as optax keeps them (bf16 LoRA factors get bf16
    moments). What remains is rounding: torch decays the parameter
    first and then adds the Adam step, and forms the first moment with
    ``lerp``, where optax sums one update and adds it; in float32 three
    steps agree to ~1e-7 relative (tests/test_torch_train.py).
  * The encoder step differentiates the tensors it is given through
    ``torch.func.functional_call``: the served `TextEncoder` keeps its
    own frozen parameters and its ``no_grad`` `apply`.
  * The LM step runs `decoder.forward` with a T-slot cache and
    ``remat`` checkpointing each layer (models/decoder.py).

Divergence: `save_train_state` / `load_train_state` write one
``torch.save`` file (params, the optimizer's ``state_dict`` and the
step) where the reference writes an orbax checkpoint directory; the two
formats do not cross. `shard_train_setup` / `shard_lm_train_setup` need
the device mesh of `parallel/mesh.py`, which is not ported yet.

No JAX function of this module reaches a Pallas kernel (encoder
training is XLA ops, and the LM forward runs with T > 1, off the
decode-attention kernel), and none has a backward kernel: autograd
through plain torch ops is the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import DeviceLike


@dataclass
class TrainState:
    params: Any     # tree (nested dicts) of trainable tensors
    opt_state: Any  # the optimizer over those tensors (`AdamW.init`)
    step: int


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [t for k in tree for t in _leaves(tree[k])]
    return [tree]


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class AdamW:
    """``optax.adamw(lr, weight_decay=...)`` as `torch.optim.AdamW`:
    ``init(params)`` returns the optimizer over the tree's leaves, which
    must be tensors that require grad."""

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay = lr, weight_decay
        self.betas, self.eps = (b1, b2), eps

    def init(self, params: Any) -> torch.optim.AdamW:
        leaves = _leaves(params)
        if not all(t.requires_grad and t.is_leaf for t in leaves):
            raise ValueError("AdamW.init needs leaf tensors that require "
                             "grad (see init_train_state)")
        return torch.optim.AdamW(leaves, lr=self.lr, betas=self.betas,
                                 eps=self.eps,
                                 weight_decay=self.weight_decay)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay)


def init_train_state(params: Any, optimizer: AdamW) -> TrainState:
    """A fresh `TrainState` over trainable copies of ``params`` (the
    tensors given are left as they are)."""
    own = _map(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(params=own, opt_state=optimizer.init(own), step=0)


def _apply_update(state: TrainState, loss: torch.Tensor) -> None:
    """One optimizer step on ``loss``; the gradients stay in ``.grad``
    until the next step."""
    opt = state.opt_state
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def contrastive_loss(za: torch.Tensor, zb: torch.Tensor,
                     temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives."""
    logits = za @ zb.T / temperature  # (B, B)
    labels = torch.arange(za.shape[0], device=za.device)
    loss_a = F.cross_entropy(logits, labels, reduction="none")
    loss_b = F.cross_entropy(logits.T, labels, reduction="none")
    return torch.mean(loss_a + loss_b) * 0.5


def matryoshka_contrastive_loss(za: torch.Tensor, zb: torch.Tensor,
                                dims: Tuple[int, ...],
                                temperature: float = 0.05) -> torch.Tensor:
    """Matryoshka representation learning: InfoNCE at every prefix
    granularity (each prefix renormalized), so ranking information
    concentrates in the leading dimensions — what the engine's cascade
    and int8 prefix scan rely on. The full-width loss is always one of
    the levels."""
    full = za.shape[-1]
    levels = sorted({min(d, full) for d in tuple(dims) + (full,)})
    total = za.new_zeros(())
    for d in levels:
        pa, pb = za[:, :d], zb[:, :d]
        pa = pa / torch.clamp(torch.linalg.vector_norm(
            pa, dim=-1, keepdim=True), min=1e-12)
        pb = pb / torch.clamp(torch.linalg.vector_norm(
            pb, dim=-1, keepdim=True), min=1e-12)
        total = total + contrastive_loss(pa, pb, temperature)
    return total / len(levels)


def _batch_tensor(a: Any, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def make_train_step(model, optimizer, *, temperature: float = 0.05,
                    matryoshka_dims: Tuple[int, ...] = ()) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``model`` is a `TextEncoder` (or `MultimodalEncoder`); state.params
    maps its parameter names to trainable tensors (`init_train_state`
    over `EncoderState.params`). batch = dict(ids_a, mask_a, ids_b,
    mask_b), tensors or numpy: two views of each pair. Non-empty
    ``matryoshka_dims`` switches to the MRL objective. Metrics are
    0-d tensors: loss and the argmax accuracy of the (B, B) match."""
    from torch.func import functional_call

    def loss_fn(params, batch):
        dev = next(iter(params.values())).device

        def embed(ids, mask):
            return functional_call(model, params, (
                _batch_tensor(ids, dev, torch.long),
                _batch_tensor(mask, dev, torch.bool)))

        za = embed(batch["ids_a"], batch["mask_a"])
        zb = embed(batch["ids_b"], batch["mask_b"])
        if matryoshka_dims:
            loss = matryoshka_contrastive_loss(za, zb, matryoshka_dims,
                                               temperature)
        else:
            loss = contrastive_loss(za, zb, temperature)
        with torch.no_grad():
            acc = torch.mean((torch.argmax(za @ zb.T, dim=-1) == torch.arange(
                za.shape[0], device=dev)).float())
        return loss, acc

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        loss, acc = loss_fn(state.params, batch)
        _apply_update(state, loss)
        return (TrainState(state.params, state.opt_state, state.step + 1),
                {"loss": loss.detach(), "accuracy": acc})

    return train_step


def lm_loss(params: Dict[str, Any], cfg, batch, *, remat: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross-entropy of the decoder over a right-padded
    batch (ids (B, T) int, mask (B, T) bool), and the argmax accuracy,
    both over the masked targets — `make_lm_train_step`'s loss and the
    LoRA step's. The forward writes a T-slot cache (positions [0, T) in
    one slice) and projects every position."""
    from .decoder import _dtype, _params_device, _project, forward

    dev = _params_device(params)
    ids = _batch_tensor(batch["ids"], dev, torch.int32)
    mask = _batch_tensor(batch["mask"], dev, torch.bool)
    B, T = ids.shape
    z = lambda: torch.zeros((cfg.num_layers, B, T, cfg.kv_heads,  # noqa: E731
                             cfg.head_dim), dtype=_dtype(cfg), device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        B, T)
    x, _, _ = forward(params, cfg, ids, positions, z(), z(), remat=remat)
    logits = _project(params, cfg, x)[:, :-1]  # predict t + 1
    targets = ids[:, 1:].long()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    m = mask[:, 1:].float()
    denom = torch.clamp(m.sum(), min=1.0)
    loss = torch.sum(nll * m) / denom
    with torch.no_grad():
        acc = torch.sum((torch.argmax(logits, -1) == targets) * m) / denom
    return loss, acc


def make_lm_train_step(cfg, optimizer, *, remat: bool = True) -> Callable:
    """Causal-LM training step for the decoder (models/decoder.py):
    next-token cross-entropy with a padding mask, AdamW, per-layer
    rematerialization (trade FLOPs for memory so depth scales).

    batch = dict(ids (B, T) int right-padded, mask (B, T) bool);
    state.params is a trainable decoder tree (plain weights: a
    ``kv_quant`` config raises in the forward)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        loss, acc = lm_loss(state.params, cfg, batch, remat=remat)
        _apply_update(state, loss)
        return (TrainState(state.params, state.opt_state, state.step + 1),
                {"loss": loss.detach(), "accuracy": acc})

    return train_step


def shard_lm_train_setup(mesh, params, cfg, optimizer, *,
                         remat: bool = True):
    """Needs `parallel/mesh.py` (not ported yet)."""
    raise NotImplementedError(
        "shard_lm_train_setup needs the device mesh of parallel/mesh.py, "
        "which is not ported yet")


def save_train_state(state: TrainState, path: str) -> None:
    """One ``torch.save`` file of the params (detached, on their
    device), the optimizer's ``state_dict`` and the step. The reference
    writes an orbax checkpoint directory instead."""
    torch.save({"params": _map(lambda t: t.detach(), state.params),
                "opt_state": state.opt_state.state_dict(),
                "step": int(state.step)}, path)


def load_train_state(path: str, optimizer: AdamW, template: TrainState,
                     device: DeviceLike = None) -> TrainState:
    """Inverse of `save_train_state`: the saved params as trainable
    tensors on the device of ``template``'s (or ``device``), with a
    fresh ``optimizer.init`` over them that loads the saved moments."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    dev = (torch.device(device) if device is not None
           else _leaves(template.params)[0].device)
    params = _map(lambda t: t.to(dev).requires_grad_(True), raw["params"])
    opt = optimizer.init(params)
    opt.load_state_dict(raw["opt_state"])
    return TrainState(params=params, opt_state=opt, step=int(raw["step"]))


def shard_train_setup(mesh, enc, optimizer, *, temperature: float = 0.05,
                      matryoshka_dims: Tuple[int, ...] = ()):
    """Needs `parallel/mesh.py` (not ported yet)."""
    raise NotImplementedError(
        "shard_train_setup needs the device mesh of parallel/mesh.py, "
        "which is not ported yet")
