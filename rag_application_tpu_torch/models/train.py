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
    `TextEncoder.forward(..., params=)`, the module's math over a
    parameter map: the served `TextEncoder` keeps its own frozen
    parameters and its ``no_grad`` `apply`.
  * The LM step runs `decoder.forward` with a T-slot cache and
    ``remat`` checkpointing each layer (models/decoder.py).

The DP x TP steps (`shard_train_setup`, `shard_lm_train_setup`, and
`models/lora.py`'s step over a sharded tree) are these same step
functions over a tree placed by `parallel/tp.py::shard_params`: params
sharded over the mesh's ``model`` axis and replicated over ``data``.
Each batch leaf splits over ``data`` and each data row runs its part of
the forward on its own replica. The LM loss is the global masked mean
(the rows' nll sums over their mask counts, not a mean of means); the
encoder's in-batch negatives span the global batch (za and zb gathered
for the (B, B) logits), as the reference's XLA program computes them.
The gradients are summed across the rows (`tp.sum_replica_grads`) and
every replica takes the same AdamW update, so the replicas stay
bit-equal. The sharded encoder step takes the unsharded step's route,
`TextEncoder.forward(..., params=)`, once a data row.

Divergence: `save_train_state` / `load_train_state` write one
``torch.save`` file (params, the optimizer's ``state_dict`` and the
step) where the reference writes an orbax checkpoint directory; the two
formats do not cross. The pair takes unsharded states only.

No JAX function of this module reaches a Pallas kernel (encoder
training is XLA ops, and the LM forward runs with T > 1, off the
decode-attention kernel), and none has a backward kernel: autograd
through plain torch ops is the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import tp
from ..parallel.mesh import batch_sharding
from ..utils import DeviceLike


@dataclass
class TrainState:
    params: Any     # tree (nested dicts) of trainable tensors
    opt_state: Any  # the optimizer over those tensors (`AdamW.init`)
    step: int


class AdamW:
    """``optax.adamw(lr, weight_decay=...)`` as `torch.optim.AdamW`:
    ``init(params)`` returns the optimizer over the tree's leaves, which
    must be tensors that require grad."""

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay = lr, weight_decay
        self.betas, self.eps = (b1, b2), eps

    def init(self, params: Any) -> torch.optim.AdamW:
        leaves = tp.tensors(params)
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
    own = tp.map_tensors(
        lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(params=own, opt_state=optimizer.init(own), step=0)


def _apply_update(state: TrainState, loss: torch.Tensor) -> None:
    """One optimizer step on ``loss``; the gradients stay in ``.grad``
    until the next step. Sharded params sum their gradients across the
    data replicas first."""
    opt = state.opt_state
    opt.zero_grad(set_to_none=True)
    loss.backward()
    tp.sum_replica_grads(state.params)
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
    def embed(params, batch):
        """Each data row embeds its part of the batch on its replica
        (one row over an unsharded map), through the module's math over
        ``params``; za and zb are gathered to the global batch on the
        first device."""
        mesh = tp.mesh_of(params)
        keys = ("ids_a", "mask_a", "ids_b", "mask_b")
        if mesh is None:
            dev = next(iter(params.values())).device
            parts, devs = {k: [batch[k]] for k in keys}, [dev]
        else:
            dev = mesh.first
            parts = {k: tp.split_batch(mesh, batch[k]) for k in keys}
            devs = list(mesh.devices[:, 0])
        za, zb = [], []
        for r, (p, d) in enumerate(zip(tp.rows(params), devs)):
            for side, out in (("a", za), ("b", zb)):
                out.append(model(
                    _batch_tensor(parts["ids_" + side][r], d, torch.long),
                    _batch_tensor(parts["mask_" + side][r], d, torch.bool),
                    params=p))
        return tp.gather_batch(za, dev), tp.gather_batch(zb, dev), dev

    def loss_fn(params, batch):
        za, zb, dev = embed(params, batch)
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
    one slice) and projects every position. Over a sharded tree with
    several data rows, each row runs its part of the batch and the
    means are global: the rows' sums over their mask counts."""
    from .decoder import _params_device

    per_row = tp.rows(params)
    if len(per_row) == 1:
        dev = _params_device(params)
        nll, count, hits = _lm_sums(
            params, cfg, _batch_tensor(batch["ids"], dev, torch.int32),
            _batch_tensor(batch["mask"], dev, torch.bool), remat)
    else:
        mesh = tp.mesh_of(params)
        ids = tp.split_batch(mesh, batch["ids"])
        mask = tp.split_batch(mesh, batch["mask"])
        sums = []
        for r, p in enumerate(per_row):
            d = mesh.devices[r, 0]
            sums.append(_lm_sums(p, cfg, _batch_tensor(ids[r], d, torch.int32),
                                 _batch_tensor(mask[r], d, torch.bool), remat))
        nll, count, hits = (tp.reduce_sum([s[i] for s in sums], mesh.first)
                            for i in range(3))
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    with torch.no_grad():
        acc = hits / denom
    return loss, acc


def _lm_sums(params: Dict[str, Any], cfg, ids: torch.Tensor,
             mask: torch.Tensor, remat: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch's masked nll sum, mask count and argmax hits."""
    from .decoder import _dtype, _project, forward

    dev = ids.device
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
    with torch.no_grad():
        hits = torch.sum((torch.argmax(logits, -1) == targets) * m)
    return torch.sum(nll * m), m.sum(), hits


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
    """Decoder-LM twin of `shard_train_setup`: params sharded over
    ``model`` by `param_shardings`' rule and replicated over ``data``,
    each batch leaf split over ``data``. Returns (state, step,
    batch_sharding)."""
    state = init_train_state(tp.shard_params(mesh, params), optimizer)
    return (state, make_lm_train_step(cfg, optimizer, remat=remat),
            batch_sharding(mesh))


def save_train_state(state: TrainState, path: str) -> None:
    """One ``torch.save`` file of the params (detached, on their
    device), the optimizer's ``state_dict`` and the step. The reference
    writes an orbax checkpoint directory instead."""
    torch.save({"params": tp.map_tensors(lambda t: t.detach(),
                                         state.params),
                "opt_state": state.opt_state.state_dict(),
                "step": int(state.step)}, path)


def load_train_state(path: str, optimizer: AdamW, template: TrainState,
                     device: DeviceLike = None) -> TrainState:
    """Inverse of `save_train_state`: the saved params as trainable
    tensors on the device of ``template``'s (or ``device``), with a
    fresh ``optimizer.init`` over them that loads the saved moments."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    dev = (torch.device(device) if device is not None
           else tp.tensors(template.params)[0].device)
    params = tp.map_tensors(lambda t: t.to(dev).requires_grad_(True),
                            raw["params"])
    opt = optimizer.init(params)
    opt.load_state_dict(raw["opt_state"])
    return TrainState(params=params, opt_state=opt, step=int(raw["step"]))


def shard_train_setup(mesh, enc, optimizer, *, temperature: float = 0.05,
                      matryoshka_dims: Tuple[int, ...] = ()):
    """Place the encoder's parameters on the mesh (sharded over
    ``model``, replicated over ``data``) with an optimizer over them,
    and return (state, step, batch_sharding): the step takes whole
    batch leaves (or lists of one part a data row) and splits each over
    ``data``."""
    state = init_train_state(tp.shard_params(mesh, enc.params), optimizer)
    step = make_train_step(enc.model, optimizer, temperature=temperature,
                           matryoshka_dims=matryoshka_dims)
    return state, step, batch_sharding(mesh)
