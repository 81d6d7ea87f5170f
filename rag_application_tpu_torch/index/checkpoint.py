"""Index checkpoint / restore.

Port of `rag_application_tpu/index/checkpoint.py`, on the same files, so
a snapshot written by either package loads in the other:

  <dir>/manifest.json      — versioned manifest: sizes, dims, config
  <dir>/dense.npz          — vecs_u16 (the bf16 plane's bits as uint16),
                             int8, int8_recip, inv_norms, live; a plane
                             the storage mode lacks is left out
  <dir>/sparse.npz         — per-doc (row, term, tf) triplets, doc
                             lengths and tombstones
  <dir>/vocab.json         — analyzer vocabulary in id order
  <dir>/payloads.json      — payload rows

Checkpoints are atomic by rename: state is written to `<dir>.tmp` and
renamed into place, so a crash mid-write never corrupts the previous
checkpoint.

bf16 planes cross to numpy as their bits (``.view(torch.int16)``, then
``uint16``) and come back with ``.view(torch.bfloat16)``: reinterpreted,
never cast. The capture runs under the collection's lock with the dense
index pinned (`DenseIndex.pin`: writes after the capture go to copies),
and the device-to-host copies after the lock is released.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..utils import DeviceLike
from .dense import _prefix_int8

MANIFEST_VERSION = 1

if TYPE_CHECKING:  # pragma: no cover
    from ..store.collection import Collection

# rows a block when the prefix table is derived on load (bounds the f32
# transient to ~256 MB at d 1024)
_PREFIX_ROWS = 65536


def bf16_to_u16(x: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its bits as a uint16 numpy array (on the host)."""
    return x.view(torch.int16).cpu().numpy().view(np.uint16)


def u16_to_bf16(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint16 bits (numpy) -> bf16 tensor on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).to(device).view(
            torch.bfloat16)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def atomic_replace(tmp: str, path: str) -> None:
    """Move the finished directory ``tmp`` to ``path`` by renames, so a
    checkpoint exists at ``path`` at every instant (the old one until the
    new one is in place)."""
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def fresh_dir(path: str) -> str:
    """``<path>.tmp``, emptied and created."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def save_collection(col: "Collection", path: str) -> None:
    # --- capture phase, under the collection's mutation lock -------------
    # A torn read (dense rows without the matching sparse/payload rows)
    # would misalign the row space on restore. Under the lock only
    # references and row-aligned host state are captured and the index
    # is pinned, so inserts and deletes after the capture write copies;
    # the device->host copies run after the lock is released.
    dense = col.dense
    with col.lock:
        dense.pin()
        r_vecs, r_int8 = dense.vecs, dense.int8
        r_recip = dense.int8_recip
        r_inv_norms, r_live = dense.inv_norms, dense.live
        d_size = dense.size

        sp = col.sparse
        # triplets cover ALL docs (tombstones re-applied on load via
        # doc_deleted), taken straight from the CSR chunks
        terms, tfs, counts, lens = sp._flat()
        n_docs = len(sp)
        deleted_rows = sorted(sp._deleted) if sp._deleted else []
        # id order == insertion order
        vocab_terms = sorted(sp.analyzer.vocab, key=sp.analyzer.vocab.get)

        payloads_json = json.dumps(col.payloads._payloads)
        n_payloads = len(col.payloads)

    try:
        d_vecs = None if r_vecs is None else bf16_to_u16(r_vecs)
        d_int8 = None if r_int8 is None else r_int8.cpu().numpy()
        d_recip = None if r_recip is None else r_recip.cpu().numpy()
        d_inv_norms = r_inv_norms.cpu().numpy()
        d_live = r_live.cpu().numpy()
    finally:
        dense.unpin()

    # --- write phase -----------------------------------------------------
    tmp = fresh_dir(path)
    # the bf16 plane is stored as bits under vecs_u16; reduced storage
    # modes leave the absent plane's key out
    vec_kw = {}
    if d_vecs is not None:
        vec_kw["vecs_u16"] = d_vecs
    if d_int8 is not None:
        vec_kw["int8"] = d_int8
    if d_recip is not None:
        vec_kw["int8_recip"] = d_recip
    np.savez(os.path.join(tmp, "dense.npz"), **vec_kw,
             inv_norms=d_inv_norms, live=d_live)

    rows = np.repeat(np.arange(n_docs, dtype=np.int64), counts)
    trip = np.stack(
        [rows, terms.astype(np.int64), tfs.astype(np.int64)], axis=1)
    deleted = np.zeros(n_docs, dtype=bool)
    if deleted_rows:
        deleted[np.asarray(deleted_rows)] = True
    np.savez(os.path.join(tmp, "sparse.npz"), triplets=trip,
             doc_lens=lens.astype(np.int64), doc_deleted=deleted)
    with open(os.path.join(tmp, "vocab.json"), "w") as f:
        json.dump(vocab_terms, f)

    with open(os.path.join(tmp, "payloads.json"), "w") as f:
        f.write(payloads_json)

    manifest = {
        "version": MANIFEST_VERSION,
        "name": col.name,
        "size": d_size,
        "dim": dense.cfg.dim,
        "matryoshka_dims": list(dense.cfg.matryoshka_dims),
        # the reference writes str() of its jnp dtype
        "vec_dtype": "bfloat16" if r_vecs is not None else None,
        "store_bf16": d_vecs is not None,
        "store_int8": d_int8 is not None,
        "int8_per_row_scale": d_recip is not None,
        "n_payloads": n_payloads,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    atomic_replace(tmp, path)


def _derive_prefix(dense) -> torch.Tensor:
    """The prefix scan table from the stored rows (bf16, or int8 in
    capacity mode), as the reference derives it on load: prefix
    renormalization is scale-invariant, so this is the inserts' table up
    to one rounding step of the stored rows."""
    src = dense.vecs if dense.vecs is not None else dense.int8
    p = dense.cfg.scan_prefix_dim
    out = torch.empty((src.shape[0], p), dtype=torch.int8, device=src.device)
    for s in range(0, src.shape[0], _PREFIX_ROWS):
        out[s:s + _PREFIX_ROWS] = _prefix_int8(
            src[s:s + _PREFIX_ROWS].float(), p)
    return out


def load_collection(path: str, config=None, *,
                    device: DeviceLike = None) -> "Collection":
    from ..store.collection import Collection
    from .payload import PayloadStore

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["version"] > MANIFEST_VERSION:
        raise ValueError(f"manifest version {manifest['version']} too new")

    col = Collection(manifest["name"], config, device=device)
    dev = col.device
    if col.cfg.index.dim != manifest["dim"]:
        raise ValueError(
            f"config dim {col.cfg.index.dim} != checkpoint dim {manifest['dim']}"
        )
    if list(col.cfg.index.matryoshka_dims) != manifest["matryoshka_dims"]:
        raise ValueError(
            f"config matryoshka dims {col.cfg.index.matryoshka_dims} != "
            f"checkpoint {manifest['matryoshka_dims']} — the inv_norms "
            "columns would be misinterpreted")

    d = np.load(os.path.join(path, "dense.npz"))
    dense = col.dense
    if manifest.get("store_bf16", True) != dense.cfg.store_bf16 or \
            manifest.get("store_int8", True) != dense.cfg.store_int8:
        raise ValueError(
            "config storage planes (bf16=%s, int8=%s) do not match the "
            "checkpoint (bf16=%s, int8=%s)" % (
                dense.cfg.store_bf16, dense.cfg.store_int8,
                manifest.get("store_bf16", True),
                manifest.get("store_int8", True)))
    if "vecs_u16" in d:
        dense.vecs = u16_to_bf16(d["vecs_u16"], dev)
    elif "vecs" in d:
        raise ValueError("checkpoint holds a non-bf16 vector plane; the "
                         "dense index stores bf16")
    if "int8" in d:
        dense.int8 = _to_device(d["int8"], dev)
    if "int8_recip" in d:
        if dense.int8_recip is None:
            raise ValueError(
                "checkpoint has per-row int8 scales but the config "
                "disables int8_per_row_scale")
        dense.int8_recip = _to_device(d["int8_recip"], dev)
    elif dense.int8_recip is not None and manifest.get("store_bf16") is False:
        raise ValueError(
            "config expects per-row int8 scales but the checkpoint "
            "predates them — set int8_per_row_scale=False to load")
    live = d["live"]
    dense.inv_norms = _to_device(d["inv_norms"], dev)
    dense.live = _to_device(live, dev)
    dense.size = int(manifest["size"])
    # the snapshot does not record delete history; derive the fast-path
    # flag from the restored mask itself
    dense.has_deletes = not bool(live[: dense.size].all())
    if dense.prefix_int8 is not None:
        dense.prefix_int8 = _derive_prefix(dense)

    s = np.load(os.path.join(path, "sparse.npz"))
    with open(os.path.join(path, "vocab.json")) as f:
        terms = json.load(f)
    sp = col.sparse
    sp.analyzer.vocab = {t: i for i, t in enumerate(terms)}
    n_docs = len(s["doc_lens"])
    trip = s["triplets"]
    if trip.shape[0]:
        order = np.argsort(trip[:, 0], kind="stable")
        trip = trip[order]
        counts = np.bincount(trip[:, 0], minlength=n_docs)
        terms, tfs = trip[:, 1], trip[:, 2]
    else:
        counts = np.zeros(n_docs, dtype=np.int64)
        terms = tfs = np.zeros(0, dtype=np.int64)
    sp._chunk_terms = []
    sp._chunk_tfs = []
    sp._chunk_counts = []
    sp._chunk_lens = []
    sp._n_docs = 0
    sp._flat_cache = None
    if n_docs:
        sp._append_chunk(terms, tfs, counts, s["doc_lens"])
    sp._deleted = {int(r) for r in np.nonzero(s["doc_deleted"])[0]}
    # the device tables are rebuilt from the restored CSR on first use
    sp._device = None
    sp._dirty = True

    with open(os.path.join(path, "payloads.json")) as f:
        payloads = json.load(f)
    store = PayloadStore()
    for p in payloads:
        if p is None:
            store._payloads.append(None)
        else:
            store.add([p])
    col.payloads = store
    return col
