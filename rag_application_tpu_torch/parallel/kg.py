"""Sharded multi-space KG search: the 4 embedded spaces over a mesh.

Port of `rag_application_tpu/parallel/kg.py`. Scales
`kg/store.py::search_across_spaces` past one device's memory — the
reference scales the same surface by growing Neo4j
(IndexerAPI/src/core/storage/neo4j_handler.py:809-827). Every space's
rows shard over the mesh axis; each shard scores its rows against the
query and emits its local top-k per space, and the per-space candidate
lists merge with one top-k on the mesh's first device — the rows never
move. Payload materialization and the score-sorted cross-space merge
stay on the host, identical to the single-device `search_across_spaces`,
so results match it.

The bf16 planes go through `ops.topk.blocked_topk`, as the single-device
`DenseIndex.search` does. Capacity mode scores int8 planes:
``(q8 . row) * (recip / 127)`` with the int8 dot exact
(`ops.topk.dot_scores`) and ``/ 127`` as a product with its f32
reciprocal, as XLA rewrites a division by a constant. The reference's
``rps > 4096`` branch takes ``lax.approx_max_k``, which is exact on the
CPU it is checked on; the port takes the exact top-k there too.

Snapshot semantics: `ShardedKGSearch` captures the store's planes at
build time (rows_per_shard padded to a power of two); call `refresh()`
after upserts. This is a search-time accelerator for big stores — small
stores keep using the single-device KGStore path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kg.store import KGStore, Space
from ..ops.quant import quantize_int8
from ..ops.topk import NEG_INF, blocked_topk, dot_scores, stable_topk
from .mesh import Mesh
from .search import merge_shards

_MIN_RPS = 8


def _pow2(n: int) -> int:
    p = _MIN_RPS
    while p < n:
        p *= 2
    return p


def build_sharded_kg(store: KGStore, n_shards: int, *,
                     capacity: bool = False) -> Dict[str, Any]:
    """Host-side snapshot of every non-empty space, padded per shard.

    capacity=False: bf16 planes (exact — same scores as the single-device
    `DenseIndex.search`). capacity=True: int8 planes + per-row 1/||row||
    reciprocals; score = (q . int8_row) / ||int8_row|| is the exact
    cosine of the *quantized* row (the int8 storage floor), which is
    what capacity-mode single-device search scores too.
    """
    spaces: Dict[Space, Dict[str, Any]] = {}
    for s, table in store.spaces.items():
        idx = table.index
        size = idx.size
        if size == 0:
            continue
        rps = _pow2((size + n_shards - 1) // n_shards)
        total = rps * n_shards
        live = np.zeros((total,), dtype=bool)
        live[:size] = idx.live[:size].cpu().numpy()
        if capacity:
            if idx.int8 is None:
                raise ValueError(f"space {s} has no int8 plane")
            plane = np.zeros((total, store.dim), dtype=np.int8)
            plane[:size] = idx.int8[:size].cpu().numpy()
            norms = np.linalg.norm(plane.astype(np.float32), axis=-1)
            recip = np.where(norms > 0, 1.0 / np.maximum(norms, 1e-12),
                             0.0).astype(np.float32)
            spaces[s] = {"plane": torch.from_numpy(plane),
                         "recip": torch.from_numpy(recip),
                         "live": torch.from_numpy(live),
                         "size": size, "rps": rps}
        else:
            if idx.vecs is None:
                raise ValueError(
                    f"space {s} is capacity-mode (no bf16 plane); build "
                    f"with capacity=True")
            plane = torch.zeros((total, store.dim), dtype=torch.bfloat16)
            plane[:size] = idx.vecs[:size].cpu().to(torch.bfloat16)
            spaces[s] = {"plane": plane, "live": torch.from_numpy(live),
                         "size": size, "rps": rps}
    return {"spaces": spaces, "capacity": capacity, "dim": store.dim,
            "n_shards": n_shards}


def place_sharded_kg(mesh: Mesh, built: Dict[str, Any], *,
                     axis: str = "data") -> Dict[str, Any]:
    """Put every plane's rows, row-sharded over ``axis``, on the shards'
    devices: each entry holds per-shard lists."""
    devs = mesh.axis_devices(axis)
    placed: Dict[Space, Dict[str, Any]] = {}
    for s, t in built["spaces"].items():
        rps = t["rps"]

        def split(x):
            return [x[i * rps:(i + 1) * rps].to(d)
                    for i, d in enumerate(devs)]

        entry = {"plane": split(t["plane"]), "live": split(t["live"]),
                 "size": t["size"], "rps": rps}
        if built["capacity"]:
            entry["recip"] = split(t["recip"])
        placed[s] = entry
    return {"spaces": placed, "capacity": built["capacity"],
            "dim": built["dim"], "axis": axis}


def _kg_search(mesh: Mesh, k: int, capacity: bool,
               tables: Sequence[Dict[str, Any]], q: torch.Tensor
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every space's top-k over its shards, merged: per space (vals
    (Q, k), ids (Q, k)) on the mesh's first device, ids global
    (= DenseIndex rows), dead/padding rows scored -inf."""
    outs = []
    for t in tables:
        size, rps = t["size"], t["rps"]
        kk = min(k, rps)
        vals_l, idx_l = [], []
        for sh, (plane, live) in enumerate(zip(t["plane"], t["live"])):
            start = sh * rps
            local_valid = min(max(size - start, 0), rps)
            qr = q.to(plane.device)
            if capacity:
                # exact int8 dot * per-row 1/||row|| / 127 — the same
                # quantized-row cosine capacity-mode DenseIndex scores
                recip = t["recip"][sh]
                scores = dot_scores(quantize_int8(qr), plane).float()
                scores = scores * (recip * (1.0 / 127.0))[None, :]
                rows = torch.arange(rps, device=plane.device)
                ok = live & (rows < local_valid)
                scores = torch.where(ok[None, :], scores, NEG_INF)
                vals, pos = stable_topk(scores, kk)
                pos = pos.to(torch.int32)
            else:
                vals, pos = blocked_topk(
                    plane, qr.to(plane.dtype), kk,
                    block_size=min(131072, rps), valid_n=local_valid,
                    filter_mask=live, approx=True)
            vals_l.append(torch.where(torch.isfinite(vals), vals, NEG_INF))
            idx_l.append(pos + start)
        outs.append(merge_shards(mesh, vals_l, idx_l,
                                 min(k, len(vals_l) * kk)))
    return outs


class ShardedKGSearch:
    """Mesh-backed `search_across_spaces` / `search_space` over a KGStore
    snapshot. Results (payloads, scores, ordering) match the single-device
    KGStore search on the same data; capacity mode scores the quantized
    rows (the int8 storage floor) like capacity-mode DenseIndex."""

    def __init__(self, store: KGStore, mesh: Mesh, *, axis: str = "data",
                 capacity: bool = False):
        self.store = store
        self.mesh = mesh
        self.axis = axis
        self.capacity = capacity
        self.placed: Dict[str, Any] = {"spaces": {}}
        self.refresh()

    def refresh(self) -> None:
        """Re-snapshot the store (call after upserts/deletes)."""
        with self.store.lock:
            built = build_sharded_kg(self.store, self.mesh.shape[self.axis],
                                     capacity=self.capacity)
        self.placed = place_sharded_kg(self.mesh, built, axis=self.axis)

    def _dispatch(self, q: np.ndarray, k: int,
                  spaces: Sequence[Space]) -> Dict[Space, Tuple]:
        tables = self.placed["spaces"]
        active = [s for s in spaces if s in tables]
        if not active:
            return {}
        qj = torch.from_numpy(np.asarray(q, dtype=np.float32)).to(
            self.mesh.first)
        qj = qj / torch.clamp(torch.linalg.vector_norm(qj, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        out = _kg_search(self.mesh, k, self.capacity,
                         [tables[s] for s in active], qj)
        return dict(zip(active, out))

    def _materialize(self, space: Space, handle, k: int,
                     filters: Dict[str, Any]) -> List[Dict[str, Any]]:
        if handle is None:
            return []
        vals, ids = handle
        table = self.store.spaces[space]
        out: List[Dict[str, Any]] = []
        for score, row in zip(vals[0].cpu().numpy(), ids[0].cpu().numpy()):
            if not np.isfinite(score):
                continue
            p = table.get(int(row))
            if p is None:
                continue
            if any(p.get(f) != v for f, v in filters.items()):
                continue
            out.append({"space": space.value, "score": float(score),
                        "row": int(row), **p})
        return out[:k]

    def search_space(self, space: Space, query_embedding, k: int = 10,
                     **filters) -> List[Dict[str, Any]]:
        q = np.asarray(query_embedding, dtype=np.float32)[None, :]
        handles = self._dispatch(q, k, [space])
        return self._materialize(space, handles.get(space), k, filters)

    def search_across_spaces(self, query_embedding, k: int = 10,
                             spaces: Optional[Sequence[Space]] = None,
                             **filters) -> List[Dict[str, Any]]:
        spaces = list(spaces or Space)
        q = np.asarray(query_embedding, dtype=np.float32)[None, :]
        handles = self._dispatch(q, k, spaces)
        merged: List[Dict[str, Any]] = []
        for s in spaces:
            merged.extend(self._materialize(s, handles.get(s), k, filters))
        merged.sort(key=lambda h: -h["score"])
        return merged[:k]


def sharded_kg_dryrun(mesh: Mesh) -> None:
    """Tiny-shape execution of the sharded KG path (driver dry run), on
    the mesh's devices."""
    rng = np.random.default_rng(0)
    dim = 64
    store = KGStore(dim=dim, device=mesh.first)
    emb = rng.standard_normal((6, dim)).astype(np.float32)
    ents = [{"id": f"e{i}", "text": f"entity {i}", "entity_type": "T",
             "entity_profile": "p"} for i in range(4)]
    store.upsert_unstructured_page(
        "doc", 1, content="page one", embedding=emb[0],
        entities=ents[:2], entity_embeddings=emb[1:3])
    store.upsert_unstructured_page(
        "doc", 2, content="page two", embedding=emb[3],
        entities=ents[2:], entity_embeddings=emb[4:6],
        relationships=[{"source": "e2", "target": "e3",
                        "relation_type": "R",
                        "relationship_profile": "rp"}],
        relationship_embeddings=emb[0:1])
    single = store.search_across_spaces(emb[1], k=4)
    sharded = ShardedKGSearch(store, mesh)
    multi = sharded.search_across_spaces(emb[1], k=4)
    assert [(h["space"], h["row"]) for h in multi] == \
        [(h["space"], h["row"]) for h in single], (multi, single)
    cap = ShardedKGSearch(store, mesh, capacity=True)
    top = cap.search_across_spaces(emb[1], k=4)
    assert top and top[0]["row"] == single[0]["row"], (top, single)
