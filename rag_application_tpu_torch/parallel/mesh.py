"""Device-mesh construction and sharding rules.

Port of `rag_application_tpu/parallel/mesh.py`. The reference's
"distribution" is request-level async fan-out over microservices
(SURVEY §2.6). The framework shards the corpus instead:

  * corpus rows shard over the `data` axis (index + search; per-shard
    candidate lists merge with one top-k),
  * query batches shard over the `data` axis,
  * encoder weights may shard over the `model` axis (tensor
    parallelism; `param_shardings` is the rule, applied by the
    parameter-sharding code that is not ported yet).

The JAX package is single-controller: one process calls the sharded
search, `shard_map` runs the body once per device and the caller gets
one replicated answer. The port keeps that shape without
`torch.distributed`. A `Mesh` is an explicit grid of `torch.device`s
with axis names; the grid may name one device more than once, which
stands in for XLA's virtual host devices (the tests' ``[cpu] * 8``, a
one-card host's ``[cuda:0] * 4``). A row-sharded array is a list of
per-shard tensors, shard s on the s-th device along the axis; the
sharded searches run the shards one after another from the calling
thread and merge their (Q, k) candidate lists on the mesh's first
device.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A (data, model) grid of devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device results are merged on."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (index 0 on the other axes): shard s
        of an array sharded over ``axis`` lives on the s-th."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, first={self.first})"


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    data: Optional[int] = None,
    model: int = 1,
    axis_names: Tuple[str, str] = ("data", "model"),
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the first n_devices devices.

    ``devices`` defaults to every CUDA device; an explicit list may
    repeat a device. The `data` axis doubles as the corpus-shard axis
    (one logical axis, two roles — queries and corpus rows never shard
    simultaneously in the same program).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[torch.device('cpu')]"
                " * n to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > len(devices):
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"devices, {len(devices)} given")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices[: data * model]):
        grid[i // model, i % model] = d
    return Mesh(grid, axis_names)


def replicated(mesh: Mesh) -> None:
    """Every device holds the whole array (``P()``): no sharded axis."""
    del mesh
    return None


def batch_sharding(mesh: Mesh, axis: str = "data") -> str:
    """Shard the leading (batch) dimension over the data axis."""
    mesh.axis_names.index(axis)
    return axis


def row_sharding(mesh: Mesh, axis: str = "data") -> str:
    """Shard corpus rows (dim 0) over the given axis."""
    mesh.axis_names.index(axis)
    return axis


def param_shardings(mesh: Mesh, params, *, axis: str = "model"):
    """Tensor-parallel sharding rules for encoder parameters: for each
    leaf, the dim that shards over ``axis``, or None (replicated).

    Policy: shard the largest dimension of any >=2D parameter over the
    model axis when divisible by its size; replicate everything else.
    With model=1 this degenerates to full replication (pure DP).
    """
    size = mesh.shape[axis]

    def rule(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if size > 1 and len(shape) >= 2:
            best = int(np.argmax(shape))
            if shape[best] % size == 0:
                return best
        return None

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return rule(tree)

    return walk(params)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def shard_rows(mesh: Mesh, x, *, axis: str = "data") -> List[torch.Tensor]:
    """Split dim 0 of ``x`` (numpy or tensor, rows divisible by the
    shard count) into one contiguous slab a shard, each on its device
    (``device_put`` with ``P(axis, ...)``). A slab already on its device
    stays a view."""
    x = _tensor(x)
    devs = mesh.axis_devices(axis)
    if x.shape[0] % len(devs):
        raise ValueError(f"{x.shape[0]} rows not divisible by {len(devs)} "
                         f"shards")
    rps = x.shape[0] // len(devs)
    return [x[s * rps:(s + 1) * rps].to(d) for s, d in enumerate(devs)]


def shard_stacked(mesh: Mesh, x, *, axis: str = "data"
                  ) -> List[torch.Tensor]:
    """Place a stacked (S, ...) array one slice a shard: shard s gets
    ``x[s]`` on its device (the reference's ``P(axis, None, ...)`` of a
    per-shard stack, read as ``x_s[0]`` inside the body)."""
    x = _tensor(x)
    devs = mesh.axis_devices(axis)
    if x.shape[0] != len(devs):
        raise ValueError(f"a stack of {x.shape[0]} for {len(devs)} shards")
    return [x[s].to(d) for s, d in enumerate(devs)]


def as_shards(mesh: Mesh, x, *, axis: str = "data", stacked: bool = False
              ) -> List[torch.Tensor]:
    """``x`` as a list of per-shard tensors: a list is checked and kept
    (each moved to its shard's device), an array is placed with
    `shard_rows` (or `shard_stacked`)."""
    if isinstance(x, (list, tuple)):
        devs = mesh.axis_devices(axis)
        if len(x) != len(devs):
            raise ValueError(f"{len(x)} shards for a {len(devs)}-way axis")
        return [_tensor(t).to(d) for t, d in zip(x, devs)]
    return (shard_stacked if stacked else shard_rows)(mesh, x, axis=axis)
