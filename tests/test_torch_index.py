"""Parity of the port's indexes (`index.dense`, `index.sparse`) and of
`state.py` with the JAX reference, on the CPU."""

import numpy as np
import pytest
import torch

from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.index.analyzer import Analyzer as JAnalyzer
from rag_application_tpu.index.dense import DenseIndex as JDenseIndex
from rag_application_tpu.index.sparse import SparseIndex as JSparseIndex
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import IndexConfig, SparseConfig
from rag_application_tpu_torch.index.analyzer import Analyzer
from rag_application_tpu_torch.index.dense import DenseIndex
from rag_application_tpu_torch.index.sparse import SparseIndex

MODES = {
    "bf16+int8": dict(),
    "int8_capacity": dict(store_bf16=False),
    "bf16_only": dict(store_int8=False),
}


def _cfgs(mode, **extra):
    kw = dict(dim=256, matryoshka_dims=(64, 128), initial_capacity=64,
              **MODES[mode], **extra)
    return JIndexConfig(**kw), IndexConfig(**kw)


def _bits(a):
    return np.asarray(a).view(np.uint16).astype(np.int32)


def dense_arrays(j):
    """The JAX index's tables as numpy (bf16 planes as uint16 bits)."""
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {
        "vecs": (np.asarray(j.vecs).view(np.uint16)
                 if j.vecs is not None else None),
        "int8": np_or_none(j.int8),
        "inv_norms": np.asarray(j.inv_norms),
        "int8_recip": np_or_none(j.int8_recip),
        "live": np.asarray(j.live),
        "prefix_int8": np_or_none(j.prefix_int8),
    }


@pytest.mark.parametrize("mode", list(MODES))
def test_dense_tables_after_insert_grow_delete(rng, mode):
    extra = dict(scan_prefix_dim=128) if mode == "bf16+int8" else {}
    jcfg, tcfg = _cfgs(mode, **extra)
    j, t = JDenseIndex(jcfg), DenseIndex(tcfg, device="cpu")
    for n in (40, 100):  # the second batch grows 64 -> 256
        x = (rng.standard_normal((n, 256))
             * np.exp(-0.01 * np.arange(256))).astype(np.float32)
        np.testing.assert_array_equal(j.insert(x), t.insert(x))
    j.delete(np.array([3, 77]))
    t.delete(np.array([3, 77]))
    assert (t.size, t.capacity, t.has_deletes, t.fully_live) == \
        (j.size, j.capacity, j.has_deletes, j.fully_live) == (140, 256, True,
                                                              False)
    ref = dense_arrays(j)
    np.testing.assert_array_equal(t.live.numpy(), ref["live"])
    # rows are normalized by an rsqrt that differs from XLA's by <= 2 ulp
    # (tests/test_torch_quant.py), so derived bf16/int8 elements may sit
    # one rounding step apart; everything else to f32 rounding
    if ref["vecs"] is not None:
        d = np.abs(_bits(t.vecs.view(torch.int16).numpy()) -
                   ref["vecs"].astype(np.int32))
        assert d.max() <= 1 and d.mean() < 1e-2
    for name in ("int8", "prefix_int8"):
        if ref[name] is not None:
            d = np.abs(getattr(t, name).numpy().astype(np.int32)
                       - ref[name].astype(np.int32))
            assert d.max() <= 1 and d.mean() < 1e-3, name
        else:
            assert getattr(t, name) is None
    np.testing.assert_allclose(t.inv_norms.numpy(), ref["inv_norms"],
                               rtol=1e-6)
    if ref["int8_recip"] is not None:
        np.testing.assert_allclose(t.int8_recip.numpy(), ref["int8_recip"],
                                   rtol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_dense_state_round_trip_and_search(rng, mode):
    jcfg, tcfg = _cfgs(mode)
    j = JDenseIndex(jcfg)
    x = (rng.standard_normal((90, 256))
         * np.exp(-0.01 * np.arange(256))).astype(np.float32)
    j.insert(x)
    j.delete(np.array([5]))
    t = state.dense_from_numpy(tcfg, dense_arrays(j), j.size, j.has_deletes,
                               device="cpu")
    ref = dense_arrays(j)
    for name, arr in ref.items():
        got = getattr(t, name)
        if arr is None:
            assert got is None
            continue
        got = got.view(torch.int16).numpy().view(np.uint16) \
            if name == "vecs" else got.numpy()
        np.testing.assert_array_equal(got, arr)  # bit-equal
    q = x[:6] + 0.05 * rng.standard_normal((6, 256)).astype(np.float32)
    jv, ji = j.search(q, 7)
    tv, ti = t.search(q, 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    cand = np.array(ji)
    np.testing.assert_allclose(t.rescore(q, cand).numpy(),
                               np.asarray(j.rescore(q, cand)), rtol=1e-5,
                               atol=1e-6)
    if j.vecs is not None:
        jv, ji = j.search_matryoshka(q, 7, 1)
        tv, ti = t.search_matryoshka(q, 7, 1)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(t.rescore(q, cand, level=0).numpy(),
                                   np.asarray(j.rescore(q, cand, level=0)),
                                   rtol=1e-5, atol=1e-6)


def _tokens(rng, n, vocab=400, length=18):
    ranks = np.arange(1, vocab + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    return rng.choice(vocab, size=(n, length), p=p)


def sparse_arrays(j):
    dv = j.device_arrays()
    terms, tfs, counts, lens = j._flat()
    pw = dv["post_weights"]
    return {
        "post_docs": np.asarray(dv["post_docs"]),
        "post_weights": None if pw is None else np.asarray(pw),
        "doc_packed": np.asarray(dv["doc_packed"]),
        "v_pad": dv["v_pad"],
        "terms": terms, "tfs": tfs, "counts": counts, "lens": lens,
        "deleted": np.array(sorted(j._deleted), dtype=np.int64),
    }


@pytest.mark.parametrize("deleted", [False, True])
def test_sparse_device_arrays(rng, deleted):
    tokens = _tokens(rng, 500)
    vocab = {f"w{i}": i for i in range(400)}
    j = JSparseIndex(JSparseConfig(max_postings_per_term=128),
                     analyzer=JAnalyzer())
    t = SparseIndex(SparseConfig(max_postings_per_term=128),
                    analyzer=Analyzer(), device="cpu")
    for idx in (j, t):
        idx.analyzer.vocab = dict(vocab)
        idx.add_pretokenized(tokens[:300])
        idx.add_batch([" ".join(f"w{x}" for x in row) for row in tokens[300:]])
        if deleted:
            idx.delete(7)
    ref = sparse_arrays(j)
    dv = t.device_arrays()
    assert dv["v_pad"] == ref["v_pad"] and dv["post_weights"] is None
    np.testing.assert_array_equal(dv["post_docs"].numpy(), ref["post_docs"])
    # term ids and the weights' f32 formula in the reference's op order:
    # bit-equal
    np.testing.assert_array_equal(dv["doc_packed"].numpy(),
                                  ref["doc_packed"])
    texts = [" ".join(f"w{x}" for x in tokens[i][:5]) for i in (1, 50, 333)]
    for a, b in zip(t.encode_queries(texts), j.encode_queries(texts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t.exact_scores(texts[0]),
                               j.exact_scores(texts[0]), rtol=1e-6)


def test_sparse_state_round_trip(rng):
    tokens = _tokens(rng, 300)
    vocab = {f"w{i}": i for i in range(400)}
    j = JSparseIndex(JSparseConfig(max_postings_per_term=128,
                                   candidate_pool=32), analyzer=JAnalyzer())
    j.analyzer.vocab = dict(vocab)
    j.add_pretokenized(tokens)
    j.delete(11)
    ref = sparse_arrays(j)
    t = state.sparse_from_numpy(SparseConfig(max_postings_per_term=128,
                                             candidate_pool=32),
                                ref, vocab, device="cpu")
    assert len(t) == len(j) == 300
    dv = t.device_arrays()
    for name in ("post_docs", "doc_packed"):
        np.testing.assert_array_equal(dv[name].numpy(), ref[name])
    texts = [" ".join(f"w{x}" for x in tokens[i][:6]) for i in (0, 11, 99)]
    js, ji = j.search(texts, 5)
    ts, ti = t.search(texts, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    # the carried host CSR rebuilds to the same tables
    t._dirty = True
    np.testing.assert_array_equal(t.device_arrays()["post_docs"].numpy(),
                                  ref["post_docs"])
