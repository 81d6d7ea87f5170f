"""Collection checkpoints across the packages: a snapshot written by the
JAX `save_collection` loads in the port's `load_collection` and the
other way round, in every storage mode, with tombstones in the dense and
the sparse index. The files themselves are the same bytes.

Tolerances: the stored tables (bf16 bits, int8, scales, inverse norms,
live flags, the sparse CSR, vocabulary, payloads) are bit-equal. The
prefix scan table is derived from the stored rows on load, as the
reference derives it: port and reference derivations, and the inserts'
table, agree to one int8 step. Searches over the same tables return the
same rows, with scores within rtol 1e-5 of the reference's (bit-equal
between two port collections on the same tables). A pinned capture is
unchanged, bit for bit, by the inserts and deletes made during it.
"""

import functools
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.index.checkpoint import \
    load_collection as j_load_collection
from rag_application_tpu.index.checkpoint import \
    save_collection as j_save_collection
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, FunnelConfig
from rag_application_tpu_torch.config import IndexConfig, SparseConfig
from rag_application_tpu_torch.index import checkpoint as tckpt
from rag_application_tpu_torch.index.checkpoint import (load_collection,
                                                        save_collection)
from rag_application_tpu_torch.store.collection import Collection

DIM = 256
MODES = {
    "full": dict(),
    "scan_prefix": dict(scan_prefix_dim=128),
    "capacity_row_scale": dict(store_bf16=False),
    "capacity_global_scale": dict(store_bf16=False, int8_per_row_scale=False),
    "bf16_only": dict(store_int8=False),
}
FILES = ("manifest.json", "dense.npz", "sparse.npz", "vocab.json",
         "payloads.json")


def small_config(cls, index, sparse, funnel, mode):
    cfg = cls()
    cfg.index = index(dim=DIM, matryoshka_dims=(64, 128), initial_capacity=16,
                      **MODES[mode])
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    return cfg


J_CFG = functools.partial(small_config, JConfig, JIndexConfig,
                          JSparseConfig, JFunnelConfig)
T_CFG = functools.partial(small_config, Config, IndexConfig, SparseConfig,
                          FunnelConfig)


def corpus(seed=3, docs=3, chunks=20):
    """(embeddings per doc, texts per doc): spectrally decaying rows and
    zipf word texts."""
    r = np.random.default_rng(seed)
    ranks = np.arange(1, 301)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    embs, texts = [], []
    for _ in range(docs):
        embs.append((r.standard_normal((chunks, DIM))
                     * np.exp(-0.01 * np.arange(DIM))).astype(np.float32))
        texts.append([" ".join(f"w{t}" for t in r.choice(300, 12, p=p))
                      for _ in range(chunks)])
    return embs, texts


def fill(col, embs, texts, *, delete="doc-1"):
    """Three documents, the second tombstoned (dense, sparse, payloads)."""
    for i, (e, t) in enumerate(zip(embs, texts)):
        col.store_document_vectors(
            f"doc-{i}", [{"text": x, "page": j} for j, x in enumerate(t)], e)
    if delete:
        col.delete_document(delete)


def queries(embs, texts, seed=5):
    r = np.random.default_rng(seed)
    rows = [(0, 1), (0, 7), (2, 3), (2, 19), (1, 4)]  # (doc, chunk)
    q = np.stack([embs[d][c] for d, c in rows])
    q = q + 0.05 * r.standard_normal(q.shape).astype(np.float32)
    return q, [texts[d][c] for d, c in rows]


def dense_arrays(j):
    """A JAX index's tables as numpy (bf16 planes as uint16 bits)."""
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": (np.asarray(j.vecs).view(np.uint16)
                     if j.vecs is not None else None),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def port_arrays(t):
    """The port index's tables as numpy, in `dense_arrays`' layout."""
    def np_or_none(x):
        return None if x is None else x.numpy()
    return {"vecs": (t.vecs.view(torch.int16).numpy().view(np.uint16)
                     if t.vecs is not None else None),
            "int8": np_or_none(t.int8), "inv_norms": t.inv_norms.numpy(),
            "int8_recip": np_or_none(t.int8_recip), "live": t.live.numpy(),
            "prefix_int8": np_or_none(t.prefix_int8)}


def assert_tables_equal(got, want, *, prefix_steps=0):
    """Stored planes bit-equal; the derived prefix table within
    ``prefix_steps`` int8 steps."""
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, name
        elif name == "prefix_int8":
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= prefix_steps, (name, d.max())
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def assert_sparse_equal(t, j):
    for a, b in zip(t._flat(), j._flat()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t._deleted == j._deleted and len(t) == len(j)
    assert t.analyzer.vocab == j.analyzer.vocab
    tv, jv = t.device_arrays(), j.device_arrays()
    for name in ("post_docs", "doc_packed"):
        np.testing.assert_array_equal(tv[name].numpy(),
                                      np.asarray(jv[name]))


def rows_scores(hits):
    return ([[h.row for h in hs] for hs in hits],
            np.array([[h.score for h in hs] for hs in hits]))


def assert_same_hits(got, want, *, exact):
    rg, sg = rows_scores(got)
    rw, sw = rows_scores(want)
    assert rg == rw
    if exact:
        np.testing.assert_array_equal(sg, sw)
    else:
        np.testing.assert_allclose(sg, sw, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_snapshot_loads_in_port(tmp_path, mode):
    embs, texts = corpus()
    jcol = JCollection("user_ck", J_CFG(mode))
    fill(jcol, embs, texts)
    path = str(tmp_path / "ck")
    j_save_collection(jcol, path)

    tload = load_collection(path, T_CFG(mode), device="cpu")
    jload = j_load_collection(path, J_CFG(mode))
    # the stored tables, bit for bit; the prefix table as derived
    want = dense_arrays(jload.dense)
    assert_tables_equal(port_arrays(tload.dense), want, prefix_steps=1)
    assert_tables_equal(port_arrays(tload.dense), dense_arrays(jcol.dense),
                        prefix_steps=1)
    assert (tload.dense.size, tload.dense.capacity, tload.dense.has_deletes) \
        == (jcol.dense.size, jcol.dense.capacity, True)
    assert_sparse_equal(tload.sparse, jcol.sparse)
    assert tload.payloads._payloads == jcol.payloads._payloads
    assert tload.chunk_count() == jcol.chunk_count() == 40
    assert tload.payloads.rows_where(document_id="doc-1") == []

    # a port collection built from the same tables with state.py
    tstate = Collection("user_ck", T_CFG(mode), device="cpu")
    fill(tstate, embs, texts)
    tstate.dense = state.dense_from_numpy(
        T_CFG(mode).index, port_arrays(tload.dense), jload.dense.size,
        jload.dense.has_deletes, device="cpu")
    tstate._fused.dense = tstate.dense
    q, qt = queries(embs, texts)
    got = tload.hybrid_search_batch(q, qt, 5)
    assert_same_hits(got, tstate.hybrid_search_batch(q, qt, 5), exact=True)
    assert_same_hits(got, jload.hybrid_search_batch(q, qt, 5), exact=False)
    assert all(h.payload["document_id"] != "doc-1" for hs in got for h in hs)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_snapshot_loads_in_jax(tmp_path, mode):
    embs, texts = corpus(seed=4)
    tcol = Collection("user_ck", T_CFG(mode), device="cpu")
    fill(tcol, embs, texts)
    path = str(tmp_path / "ck")
    save_collection(tcol, path)

    jload = j_load_collection(path, J_CFG(mode))
    assert_tables_equal(dense_arrays(jload.dense), port_arrays(tcol.dense),
                        prefix_steps=1)
    assert (jload.dense.size, jload.dense.has_deletes) == (tcol.dense.size,
                                                           True)
    assert_sparse_equal(tcol.sparse, jload.sparse)
    assert jload.payloads._payloads == tcol.payloads._payloads
    q, qt = queries(embs, texts)
    assert_same_hits(jload.hybrid_search_batch(q, qt, 5),
                     tcol.hybrid_search_batch(q, qt, 5), exact=False)

    # the port's own round trip, and the files the reference writes from
    # the restored state are the port's, byte for byte
    tload = load_collection(path, T_CFG(mode), device="cpu")
    assert_tables_equal(port_arrays(tload.dense), port_arrays(tcol.dense),
                        prefix_steps=1)
    assert_same_hits(tload.hybrid_search_batch(q, qt, 5),
                     tcol.hybrid_search_batch(q, qt, 5),
                     exact=MODES[mode].get("scan_prefix_dim") is None)
    again = str(tmp_path / "again")
    j_save_collection(jload, again)
    for name in FILES:
        with open(os.path.join(path, name), "rb") as a, \
                open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name


def test_prefix_table_derived_on_load(tmp_path):
    """The prefix table rebuilt from the stored rows: the reference's
    derivation and the port's insert table, within one int8 step."""
    embs, texts = corpus(seed=6)
    tcol = Collection("user_ck", T_CFG("scan_prefix"), device="cpu")
    fill(tcol, embs, texts, delete=None)
    path = str(tmp_path / "ck")
    save_collection(tcol, path)
    tload = load_collection(path, T_CFG("scan_prefix"), device="cpu")
    jload = j_load_collection(path, J_CFG("scan_prefix"))
    derived = tload.dense.prefix_int8.numpy().astype(np.int32)
    for other in (tcol.dense.prefix_int8.numpy(),
                  np.asarray(jload.dense.prefix_int8)):
        d = np.abs(derived - other.astype(np.int32))
        assert d.max() <= 1 and d.mean() < 0.05
    # rows beyond the size stay zero, as the reference's
    assert not derived[tload.dense.size:].any()


class _CaptureHook:
    """A lock that runs ``after`` once, right after the first release
    that follows `arm()`: the moment `save_collection` has captured its
    references and has not yet copied them to the host."""

    def __init__(self, lock):
        self.lock = lock
        self.after = None

    def __enter__(self):
        return self.lock.__enter__()

    def __exit__(self, *exc):
        out = self.lock.__exit__(*exc)
        fn, self.after = self.after, None
        if fn is not None:
            fn()
        return out


@pytest.mark.parametrize("mode", ["full", "capacity_row_scale"])
def test_pinned_capture_survives_writes(tmp_path, mode):
    embs, texts = corpus(seed=7)
    tcol = Collection("user_ck", T_CFG(mode), device="cpu")
    fill(tcol, embs[:2], texts[:2], delete=None)
    captured = {k: None if v is None else v.copy()
                for k, v in port_arrays(tcol.dense).items()}
    size = tcol.dense.size
    cap = tcol.dense.capacity
    hook = _CaptureHook(tcol.lock)
    tcol.lock = hook

    def write():
        # an insert that fits the capacity (so it writes in place) and a
        # delete, between the capture and the copies
        assert tcol.dense.size + 20 <= cap
        tcol.store_document_vectors(
            "doc-new", [{"text": t} for t in texts[2]], embs[2])
        tcol.delete_document("doc-0")

    hook.after = write
    path = str(tmp_path / "ck")
    save_collection(tcol, path)
    assert hook.after is None  # the writes ran inside the save
    assert tcol.dense.size == size + 20 and tcol.chunk_count() == size

    tload = load_collection(path, T_CFG(mode), device="cpu")
    assert tload.dense.size == size and not tload.dense.has_deletes
    assert_tables_equal(port_arrays(tload.dense), captured)
    assert tload.chunk_count() == size
    assert len(tload.payloads) == size and len(tload.sparse) == size
    # the writes landed in the live collection's copies
    live = tcol.dense.live.numpy()
    assert not live[:20].any() and live[20:size + 20].all()
    assert not tcol.dense._captured


@pytest.mark.parametrize("mode", ["full", "capacity_row_scale"])
def test_unpin_leaves_the_capture_to_the_next_write(mode):
    """Two saves overlap: one pins and captures, the other's unpin lands
    before the first has copied. The next insert and delete must still
    go to copies: the planes the first save holds stay as captured."""
    embs, texts = corpus(seed=9)
    tcol = Collection("user_ck", T_CFG(mode), device="cpu")
    fill(tcol, embs[:1], texts[:1], delete=None)
    dense = tcol.dense
    dense.pin()
    held = {n: getattr(dense, n) for n in dense._PLANES}
    want = {n: None if t is None else t.clone() for n, t in held.items()}
    dense.unpin()  # the other save's
    assert dense._captured
    assert dense.size + 4 <= dense.capacity  # the insert writes in place
    tcol.store_document_vectors(
        "doc-new", [{"text": t} for t in texts[1][:4]], embs[1][:4])
    tcol.delete_document("doc-0")
    for n, t in held.items():
        if t is not None:
            assert torch.equal(t, want[n]), n
    assert not dense._captured and not dense.live[:20].any()


def test_saves_under_concurrent_writes(tmp_path):
    """Saves in one thread while another inserts and deletes: every
    snapshot is row-aligned (dense size == sparse docs == payload rows)
    and each live row has its payload."""
    embs, texts = corpus(seed=8, docs=8, chunks=6)
    tcol = Collection("user_ck", T_CFG("full"), device="cpu")
    fill(tcol, embs[:1], texts[:1], delete=None)
    errors = []

    def writer():
        try:
            for i in range(1, 8):
                tcol.store_document_vectors(
                    f"doc-{i}", [{"text": t} for t in texts[i]], embs[i])
                if i % 2:
                    tcol.delete_document(f"doc-{i - 1}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=writer)
        t.start()
        snaps = []
        while t.is_alive() or not snaps:
            path = str(tmp_path / f"ck{len(snaps)}")
            save_collection(tcol, path)
            snaps.append(path)
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and not errors, errors
    for path in snaps:
        col = load_collection(path, T_CFG("full"), device="cpu")
        n = col.dense.size
        assert len(col.sparse) == len(col.payloads) == n
        live = col.dense.live.numpy()
        assert not live[n:].any()
        for r in np.flatnonzero(live):
            assert col.payloads.get(int(r)) is not None
            assert not col.sparse.is_deleted(int(r))


def test_failed_write_keeps_previous_snapshot(tmp_path, monkeypatch):
    embs, texts = corpus(seed=9)
    tcol = Collection("user_ck", T_CFG("full"), device="cpu")
    fill(tcol, embs[:1], texts[:1], delete=None)
    path = str(tmp_path / "ck")
    save_collection(tcol, path)
    with open(os.path.join(path, "manifest.json")) as f:
        first = json.load(f)
    fill(tcol, embs[1:], texts[1:], delete=None)

    real = np.savez

    def failing(file, **arrays):
        if str(file).endswith("sparse.npz"):
            raise OSError("disk full")
        return real(file, **arrays)

    monkeypatch.setattr(tckpt.np, "savez", failing)
    with pytest.raises(OSError, match="disk full"):
        save_collection(tcol, path)
    monkeypatch.setattr(tckpt.np, "savez", real)
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f) == first
    old = load_collection(path, T_CFG("full"), device="cpu")
    assert old.dense.size == 20 and old.chunk_count() == 20
    # the next save replaces it and leaves no working directories
    save_collection(tcol, path)
    assert load_collection(path, T_CFG("full"), device="cpu").dense.size == 60
    assert sorted(os.listdir(tmp_path)) == ["ck"]
