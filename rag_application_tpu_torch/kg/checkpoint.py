"""KGStore checkpoint / restore (graph + 4 vector spaces).

Port of `rag_application_tpu/kg/checkpoint.py`, on the same files, so a
snapshot written by either package loads in the other: `spaces.npz`
(per space the bf16 plane's bits as uint16, the int8 plane and the live
flags), `graph.json` (documents, pages, edges, mentions, column values,
scope) and `manifest.json` (per space its size, payloads and keys).
Atomic by rename, like `index/checkpoint.py`.

The capture runs under the store's lock with every space's index pinned
(`DenseIndex.pin`: writes after the capture go to copies), the host dicts
serialized to JSON there; the device-to-host copies run after the lock
is released.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import KGConfig
from ..index.checkpoint import (atomic_replace, bf16_to_u16, fresh_dir,
                                u16_to_bf16)
from ..utils import DeviceLike
from .store import KGStore, Space

KG_MANIFEST_VERSION = 1


def _dump_array(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return bf16_to_u16(x)
    return x.cpu().numpy()


def save_kg(kg: KGStore, path: str) -> None:
    # --- capture under the store's mutation lock -------------------------
    with kg.lock:
        refs = {}
        meta_spaces = {}
        for space, table in kg.spaces.items():
            idx = table.index
            idx.pin()
            refs[space.value] = (idx, idx.vecs, idx.int8, idx.live)
            meta_spaces[space.value] = {
                "size": idx.size,
                "bf16": idx.vecs.dtype == torch.bfloat16,
                "payloads": table.payloads,
                "by_key": [[list(k), v] for k, v in table.by_key.items()],
            }
        graph = {
            "documents": kg.documents,
            "doc_pages": {d: {str(p): r for p, r in pages.items()}
                          for d, pages in kg.doc_pages.items()},
            "entity_edges": {str(k): v for k, v in kg.entity_edges.items()},
            "page_mentions": {str(k): v for k, v in kg.page_mentions.items()},
            "column_values": {str(k): v for k, v in kg.column_values.items()},
            "scope": kg.scope,
        }
        graph_json = json.dumps(graph, default=str)
        manifest_json = json.dumps(
            {"version": KG_MANIFEST_VERSION, "dim": kg.dim,
             "spaces": meta_spaces}, default=str)

    arrays = {}
    try:
        for name, (idx, vecs, int8, live) in refs.items():
            arrays[f"{name}_vecs"] = _dump_array(vecs)
            arrays[f"{name}_int8"] = int8.cpu().numpy()
            arrays[f"{name}_live"] = live.cpu().numpy()
    finally:
        for idx, *_ in refs.values():
            idx.unpin()

    # --- write phase -----------------------------------------------------
    tmp = fresh_dir(path)
    np.savez(os.path.join(tmp, "spaces.npz"), **arrays)
    with open(os.path.join(tmp, "graph.json"), "w") as f:
        f.write(graph_json)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        f.write(manifest_json)
    atomic_replace(tmp, path)


def load_kg(path: str, config: Optional[KGConfig] = None, *,
            device: DeviceLike = None) -> KGStore:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["version"] > KG_MANIFEST_VERSION:
        raise ValueError("manifest too new")
    with open(os.path.join(path, "graph.json")) as f:
        graph = json.load(f)

    kg = KGStore(config, dim=manifest["dim"], scope=graph.get("scope") or {},
                 device=device)
    dev = kg.device
    data = np.load(os.path.join(path, "spaces.npz"), allow_pickle=False)
    for space in Space:
        meta = manifest["spaces"][space.value]
        idx = kg.spaces[space].index
        if not meta["bf16"]:
            raise ValueError(f"{space.value}: checkpoint holds a non-bf16 "
                             "vector plane; the dense index stores bf16")
        idx.vecs = u16_to_bf16(data[f"{space.value}_vecs"], dev)
        idx.int8 = torch.from_numpy(data[f"{space.value}_int8"]).to(dev)
        live = data[f"{space.value}_live"]
        idx.live = torch.from_numpy(live).to(dev)
        idx.inv_norms = torch.zeros((idx.vecs.shape[0], 0),
                                    dtype=torch.float32, device=dev)
        idx.size = int(meta["size"])
        idx.has_deletes = not bool(live[: idx.size].all())
        table = kg.spaces[space]
        table.payloads = meta["payloads"]
        table.by_key = {tuple(k): v for k, v in meta["by_key"]}
        table.by_id = {}
        for k, v in table.by_key.items():
            table.by_id.setdefault(k[1], {})[k] = v

    kg.documents = graph["documents"]
    kg.doc_pages = {d: {int(p): r for p, r in pages.items()}
                    for d, pages in graph["doc_pages"].items()}
    kg.entity_edges = {int(k): [tuple(e) for e in v]
                       for k, v in graph["entity_edges"].items()}
    kg.page_mentions = {int(k): v for k, v in graph["page_mentions"].items()}
    kg.column_values = {int(k): v for k, v in graph["column_values"].items()}
    # the snapshot may hold edge pairs of relationship rows tombstoned
    # since its last prune: let the next page upsert drop them
    kg._rels_pruned_at = -1
    return kg
