"""Tensor parallelism over the mesh's ``model`` axis: parameter sharding
and the collectives it needs, in plain torch.

The JAX package shards a parameter tree with one call,
``jax.device_put(params, param_shardings(mesh, params))``
(`parallel/mesh.py`), and from then on every entry point runs unchanged:
XLA's SPMD partitioner inserts the collectives. The port has no
partitioner. This module is its stand-in: `shard_params` places the tree,
and the model code (`models/decoder.py`, `models/encoder.py`,
`models/train.py`) calls the collectives XLA would insert, written here
as plain functions on tensors:

  * `reduce_sum`: the partial products of a weight sharded on its
    contraction dimension, summed on the merge device;
  * `concat`: the output slices of a weight sharded on its output
    dimension, concatenated there (or kept apart as `Parts` when the next
    product contracts over the same split: the Megatron MLP);
  * `take_rows`: an embedding lookup over a vocabulary-split table: each
    shard looks up the ids in its range with the rest masked to zero, and
    the results are summed;
  * `sum_replica_grads`: the gradient all-reduce across `data` replicas;
  * `gather_batch`: the global-batch gathers the losses need.

Every move between devices goes through `move`, the port's interconnect.
Activations move; a weight matrix never leaves its shard's device. Vectors
(norm weights, biases, int8 scales) may be gathered per call (`full`).

Layout. A `Sharded` leaf over a (data D, model M) mesh holds
``shards[r][j]``: the j-th of M contiguous equal slices of the leaf along
its sharded dimension, on ``mesh.devices[r, j]``, for every data row r
(the replicas). A leaf the rule replicates holds one whole tensor a row,
on the row's first device. The row's first device is its merge device:
attention, norms, sampling and the caches run there on whole tensors.
Single controller, as `parallel/mesh.py`: the shards run one after
another from the calling thread, and a grid may name one device more than
once (``[cuda:0] * 4`` on a one-card host). Leaves stay plain tensors or
lists of them: no ``DTensor`` and no ``torch.distributed`` process group
(a rank per card cannot merge on a one-card host, and the reference's
program is one process).

The rule (`parallel/mesh.py::param_shardings`): each leaf of rank 2 or
more shards its largest dimension (the first on ties) when the axis size
divides it; every other leaf is replicated. At TinyLlama-1.1B width
(vocab 32000, hidden 2048, 22 layers, 32 heads, 4 KV heads, MLP 5632) and
model=2 it gives, for the decoder tree and its int8 form
(`quantize_decoder_params`):

  ====================  ==================  ===========  ============
  leaf                  shape               sharded dim  kind
  ====================  ==================  ===========  ============
  tok_emb               (32000, 2048)       0            vocab split
  attn_norm, ffn_norm   (22, 2048)          1            vector
  wq, wo                (22, 2048, 2048)    1            contraction
  wk, wv                (22, 2048, 256)     1            contraction
  w_gate, w_up          (22, 2048, 5632)    2            output
  w_down                (22, 5632, 2048)    1            contraction
  lm_head               (2048, 32000)       1            output
  int8 scales s of the  (22, out)           1 (out)      vector
  seven projections
  final_norm,           1-D                 none         replicated
  tok_emb's and
  lm_head's scales
  ====================  ==================  ===========  ============

LoRA factors follow the same rule: ``a`` (L, H, r) on H (contraction),
``b`` (L, r, out) on out (output); the scale ``s`` (L, 1, 1) shards on
the layer axis when M divides L, and a layer's slice is then read from
the shard that holds it.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, as_shards, param_shardings


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The interconnect: ``t`` on ``device`` (itself when it is there)."""
    return t.to(device)


class Sharded:
    """One parameter leaf placed on a mesh: ``shards[r][j]`` is data row
    r's slice j along ``dim`` (None: replicated, one whole tensor a
    row)."""

    __slots__ = ("mesh", "dim", "shards")

    def __init__(self, mesh: Mesh, dim: Optional[int],
                 shards: List[List[torch.Tensor]]):
        self.mesh, self.dim, self.shards = mesh, dim, shards

    @property
    def pieces(self) -> List[torch.Tensor]:
        """Data row 0's slices (its whole tensor when replicated)."""
        return self.shards[0]

    @property
    def device(self) -> torch.device:
        """The merge device: the first device of data row 0."""
        return self.mesh.devices[0, 0]

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def ndim(self) -> int:
        return self.pieces[0].dim()

    @property
    def shape(self) -> tuple:
        shape = list(self.pieces[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(p.shape[self.dim] for p in self.pieces)
        return tuple(shape)

    @property
    def rows(self) -> int:
        return len(self.shards)

    def row(self, r: int) -> "Sharded":
        """Data row r alone, on a one-row mesh (the same tensors)."""
        mesh = Mesh(self.mesh.devices[r:r + 1], self.mesh.axis_names)
        return Sharded(mesh, self.dim, [self.shards[r]])

    def tensors(self) -> Iterator[torch.Tensor]:
        for row in self.shards:
            yield from row

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        return Sharded(self.mesh, self.dim,
                       [[fn(t) for t in row] for row in self.shards])

    def layer(self, i: int) -> "Sharded":
        """Index the leading (layer) axis. A leaf sharded on that axis
        gives the slice of the shard that holds layer i, moved to each
        row's merge device (such leaves are small: LoRA scales)."""
        if self.dim is None:
            return Sharded(self.mesh, None, [[row[0][i]] for row in self.shards])
        if self.dim > 0:
            return Sharded(self.mesh, self.dim - 1,
                           [[p[i] for p in row] for row in self.shards])
        j, k = divmod(i, self.pieces[0].shape[0])
        return Sharded(self.mesh, None, [
            [move(row[j][k], self.mesh.devices[r, 0])]
            for r, row in enumerate(self.shards)])

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dim={self.dim}, "
                f"rows={self.rows}, pieces={len(self.pieces)})")


class Parts:
    """An activation split along its last dimension, piece j on shard
    j's device: the output of an output-sharded product kept apart for
    a product that contracts over the same split."""

    __slots__ = ("pieces", "merge")

    def __init__(self, pieces: List[torch.Tensor], merge: torch.device):
        self.pieces, self.merge = pieces, merge

    @property
    def sizes(self) -> List[int]:
        return [p.shape[-1] for p in self.pieces]


def is_sharded(tree: Any) -> bool:
    """Whether ``tree`` is, or holds, a `Sharded` leaf."""
    if isinstance(tree, Sharded):
        return True
    if isinstance(tree, torch.Tensor):
        return False
    if isinstance(tree, Mapping):
        return any(map(is_sharded, tree.values()))
    if isinstance(tree, (list, tuple)):
        return any(map(is_sharded, tree))
    return False


def full(x: Any) -> Any:
    """The whole value on the merge device: a sharded leaf's row-0
    slices concatenated (vectors), `Parts` concatenated; a tensor as it
    is."""
    if isinstance(x, Sharded):
        if x.dim is None:
            return x.pieces[0]
        return concat(x.pieces, x.dim, x.device)
    if isinstance(x, Parts):
        return concat(x.pieces, -1, x.merge)
    return x


def reduce_sum(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The sum of partial products on ``device``, in shard order; half
    precision partials are added in float32 and rounded once."""
    dt = parts[0].dtype
    low = dt in (torch.bfloat16, torch.float16)
    out = move(parts[0], device)
    out = out.float() if low else out
    for p in parts[1:]:
        p = move(p, device)
        out = out + (p.float() if low else p)
    return out.to(dt) if low else out


def concat(parts: Sequence[torch.Tensor], dim: int,
           device: torch.device) -> torch.Tensor:
    """Output slices concatenated along ``dim`` on ``device``."""
    if len(parts) == 1:
        return move(parts[0], device)
    return torch.cat([move(p, device) for p in parts], dim=dim)


def pointwise(fn: Callable, *xs: Any) -> Any:
    """``fn`` piece by piece over `Parts` with one split (no move), or
    over the whole values otherwise."""
    if all(isinstance(x, Parts) for x in xs) and len(
            {tuple(x.sizes) for x in xs}) == 1:
        return Parts([fn(*ps) for ps in zip(*(x.pieces for x in xs))],
                     xs[0].merge)
    return fn(*(full(x) for x in xs))


def _cast_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _contract(x: Any, w: Sharded, local: Callable) -> torch.Tensor:
    """``local(x_j, w_j)`` on each shard of a contraction-sharded 2-D
    weight (x split to match, or `Parts` already split so), summed on the
    merge device."""
    devs = w.mesh.devices[0]
    sizes = [p.shape[0] for p in w.pieces]
    if isinstance(x, Parts) and x.sizes == sizes:
        xs = x.pieces
    else:
        xs = full(x).split(sizes, dim=-1)
    return reduce_sum([local(move(xj, d), wj)
                       for xj, wj, d in zip(xs, w.pieces, devs)], w.device)


def _aligned(v: Any, sizes: List[int]) -> List[torch.Tensor]:
    """A vector's slices matching an output split: its own pieces when it
    is sharded the same way, else slices of the whole vector."""
    if isinstance(v, Sharded) and v.dim == v.ndim - 1 and [
            p.shape[-1] for p in v.pieces] == sizes:
        return v.pieces
    return list(full(v).split(sizes, dim=-1))


def matmul(x: Any, w: Any, local: Callable, *, split: bool = False) -> Any:
    """``x @ w`` for one layer's weight whose leaves are `Sharded`: a
    plain matrix, an int8 ``{"q", "s"}`` pair or a LoRA wrapper ``{"w",
    "a", "b", "s"}``. ``local(x, w)`` is the model's one-device product,
    run on each shard with that shard's slices. A contraction-sharded
    weight's partials are summed (`reduce_sum`); an output-sharded one's
    slices are concatenated, or returned as `Parts` with ``split``. The
    result lies on the merge device unless it is `Parts`."""
    if isinstance(w, torch.Tensor):
        return local(full(x), w)
    if isinstance(w, Mapping) and "a" in w:  # LoRA wrapper
        x = full(x)
        y = full(matmul(x, w["w"], local))
        lo = full(matmul(matmul(x, w["a"], _cast_mm), w["b"], _cast_mm))
        return y + lo * full(w["s"]).to(x.dtype)
    if isinstance(w, Mapping):  # {"q", "s"}: one scale per output channel
        q, s = w["q"], w["s"]
        if q.dim == 0:
            y = _contract(x, q, _cast_mm)
            return y * move(full(s), y.device).to(y.dtype)
        if q.dim is None:
            return local(full(x), {"q": q.pieces[0], "s": full(s)})
        sizes = [p.shape[-1] for p in q.pieces]
        xf = full(x)
        outs = [local(move(xf, d), {"q": qj, "s": move(sj, d)})
                for qj, sj, d in zip(q.pieces, _aligned(s, sizes),
                                     q.mesh.devices[0])]
        return Parts(outs, q.device) if split else concat(outs, -1, q.device)
    if w.dim == 0:
        return _contract(x, w, local)
    if w.dim is None:
        return local(full(x), w.pieces[0])
    xf = full(x)
    outs = [local(move(xf, d), wj) for wj, d in zip(w.pieces,
                                                     w.mesh.devices[0])]
    return Parts(outs, w.device) if split else concat(outs, -1, w.device)


def take_rows(table: Any, ids: torch.Tensor, local: Callable
              ) -> torch.Tensor:
    """An embedding lookup ``local(table, ids)`` over a sharded table (a
    matrix or an int8 ``{"q", "s"}`` pair with one scale a row). A
    vocabulary-split table looks up on each shard the ids in its range,
    masks the rest to zero and sums the results (exact: one term is
    nonzero); a table split along its width concatenates the slices."""
    quant = isinstance(table, Mapping)
    main = table["q"] if quant else table
    dev = main.device
    if main.dim is None:
        return local({"q": main.pieces[0], "s": full(table["s"])}
                     if quant else main.pieces[0], ids)
    devs = main.mesh.devices[0]
    if main.dim == 1:
        s = full(table["s"]) if quant else None
        return concat([local({"q": p, "s": move(s, d)} if quant else p,
                             move(ids, d))
                       for p, d in zip(main.pieces, devs)], -1, dev)
    parts, lo = [], 0
    s = full(table["s"]) if quant else None
    for p, d in zip(main.pieces, devs):
        n = p.shape[0]
        i = move(ids, d).long()
        ok = (i >= lo) & (i < lo + n)
        sub = {"q": p, "s": move(s[lo:lo + n], d)} if quant else p
        rows = local(sub, torch.where(ok, i - lo, torch.zeros_like(i)))
        parts.append(torch.where(ok[..., None], rows, torch.zeros_like(rows)))
        lo += n
    return reduce_sum(parts, dev)


# ---------------------------------------------------------------- trees


def _walk(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, Mapping):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn) for v in tree)
    return fn(tree)


def _split(t: torch.Tensor, dim: Optional[int], row: Sequence[Any]
           ) -> List[torch.Tensor]:
    if dim is None:
        return [move(t, row[0]).contiguous()]
    n = t.shape[dim] // len(row)
    return [move(t.narrow(dim, j * n, n), d).contiguous()
            for j, d in enumerate(row)]


def shard_params(mesh: Mesh, tree: Any, *, axis: str = "model") -> Any:
    """Place a parameter tree on ``mesh``: the counterpart of
    ``jax.device_put(tree, param_shardings(mesh, tree))``. Every tensor
    leaf becomes a `Sharded` leaf split by `param_shardings`' rule into
    contiguous equal slices, one a device of each data row; the model
    code takes the result where it takes the tree."""
    if mesh.axis_names[1] != axis:
        raise ValueError(f"shard over the mesh's second axis, {axis!r}")
    if isinstance(tree, Mapping) and ("w_kva" in tree or "router" in tree):
        raise ValueError("tensor parallelism is not supported with latent "
                         "attention or experts")
    dims = param_shardings(mesh, tree, axis=axis)

    def place(leaf, dim):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.as_tensor(np.asarray(leaf))
        return Sharded(mesh, dim, [_split(leaf, dim, row)
                                   for row in mesh.devices])

    def walk(t, d):
        if isinstance(t, Mapping):
            return {k: walk(v, d[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, dv) for v, dv in zip(t, d))
        return place(t, d)

    return walk(tree, dims)


def gather_params(tree: Any) -> Any:
    """The exact inverse of `shard_params`: every `Sharded` leaf as one
    tensor on its merge device (data row 0's slices concatenated)."""
    return _walk(tree, lambda x: full(x) if isinstance(x, Sharded) else x)


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` over every tensor of a tree, a `Sharded` leaf's slices
    included (their layout kept)."""
    return _walk(tree, lambda x: x.map(fn) if isinstance(x, Sharded)
                 else fn(x))


def tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor of a tree, a `Sharded` leaf's slices of every row."""
    out: List[torch.Tensor] = []
    _walk(tree, lambda x: out.extend(x.tensors()) if isinstance(x, Sharded)
          else out.append(x))
    return out


def mesh_of(tree: Any) -> Optional[Mesh]:
    """The mesh of a tree's first `Sharded` leaf (None: not sharded)."""
    found: List[Mesh] = []
    _walk(tree, lambda x: found.append(x.mesh)
          if isinstance(x, Sharded) and not found else None)
    return found[0] if found else None


def rows(tree: Any) -> List[Any]:
    """The tree as each data row sees it: one tree a row, its `Sharded`
    leaves restricted to that row (`Sharded.row`)."""
    mesh = mesh_of(tree)
    n = 1 if mesh is None else mesh.devices.shape[0]
    return [_walk(tree, lambda x, r=r: x.row(r) if isinstance(x, Sharded)
                  else x) for r in range(n)]


def split_batch(mesh: Mesh, x: Any) -> List[torch.Tensor]:
    """A batch leaf split over the ``data`` axis, row r's part on row r's
    merge device (`parallel/mesh.py::as_shards`; a list is kept)."""
    return as_shards(mesh, x, axis=mesh.axis_names[0])


def gather_batch(parts: Sequence[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    """The global batch on ``device``: the rows' parts concatenated along
    dim 0."""
    return concat(parts, 0, device)


def sum_replica_grads(tree: Any) -> None:
    """The gradient all-reduce across ``data`` replicas: for each slice
    position of each `Sharded` leaf, the rows' ``.grad`` summed in row
    order on row 0's device and the same sum written to every row, so
    every replica takes the same optimizer update."""
    def one(x):
        if not isinstance(x, Sharded) or x.rows == 1:
            return
        for j in range(len(x.pieces)):
            ts = [row[j] for row in x.shards]
            gs = [t.grad for t in ts]
            if any(g is None for g in gs):
                continue
            g = reduce_sum(gs, ts[0].device)
            for t in ts:
                t.grad = move(g, t.device).clone()

    _walk(tree, one)


def replicas_equal(tree: Any) -> bool:
    """Whether every data row of every `Sharded` leaf holds the same
    values as row 0, bit for bit."""
    ok = [True]

    def one(x):
        if isinstance(x, Sharded):
            for row in x.shards[1:]:
                for a, b in zip(x.pieces, row):
                    if not torch.equal(a.detach(), move(b.detach(), a.device)):
                        ok[0] = False

    _walk(tree, one)
    return ok[0]
