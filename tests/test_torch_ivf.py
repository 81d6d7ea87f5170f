"""The IVF ANN engine (`index/ivf.py`) and `Collection.build_ann` /
`ann_search` against the JAX reference, on the CPU.

The reference's IVF index is carried into the port through its own
`.npz` (`IVFIndex.save` -> the port's `IVFIndex.load`), and its dense
tables through `state.dense_from_numpy`, so both packages search the same
partition over the same rows. Then, on noisy corpus rows:

  * ids and int8-stage scores (``rescore=False``) are bit-equal at probes
    8, 32 and every bucket, with a tail of rows inserted after the build,
    with filters, with tombstones and in capacity mode (int8 only, per-row
    scale); with the rescore on, scores are within 1e-6 absolute (both
    sides sum an f32 dot, in different orders) and ids equal but where
    two candidates' exact scores are that close;
  * the port's own build over the same rows gives centroids within 1e-5
    of the reference's, but for the two that one near-tie training row
    moves (stated at the test), and the same bucket layout;
  * files cross the packages both ways;
  * the probe-chunked layout, with chunks that leave padding probes,
    answers bit for bit as one chunk does, and rows wider than one exact
    f32 piece (d > 1024) keep exact int8 dots;
  * the port passes every case of tests/test_ivf.py and
    tests/test_ann_integration.py.
"""

import functools

import numpy as np
import pytest
import torch

from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.index.dense import DenseIndex as JDenseIndex
from rag_application_tpu.index.ivf import IVFIndex as JIVFIndex
from rag_application_tpu.index.ivf import IVFSearchParams as JParams
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, FunnelConfig
from rag_application_tpu_torch.config import IndexConfig, SparseConfig
from rag_application_tpu_torch.index import ivf as tivf
from rag_application_tpu_torch.index.dense import DenseIndex
from rag_application_tpu_torch.index.ivf import IVFIndex, IVFSearchParams
from rag_application_tpu_torch.ops.rrf import INVALID_ID
from rag_application_tpu_torch.store.collection import Collection

N, D = 20_000, 64
BUILD = dict(n_clusters=128, bucket_rows=32, iters=8, block_rows=4096)


def clustered_corpus(rng, n, d, n_clusters=64, noise=0.25):
    """tests/test_ivf.py's corpus."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    x = centers[assign] + noise * rng.standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    vecs = None if j.vecs is None else np.asarray(j.vecs).view(np.uint16)
    return {"vecs": vecs, "int8": np_or_none(j.int8),
            "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def carry_dense(jdense, cfg):
    return state.dense_from_numpy(cfg, dense_arrays(jdense), jdense.size,
                                  jdense.has_deletes, device="cpu")


def carry_ivf(jivf, tdense, tmp_path, name="ivf.npz"):
    path = str(tmp_path / name)
    jivf.save(path)
    return IVFIndex.load(path, tdense)


@functools.lru_cache(maxsize=None)
def _reference(store_bf16=True):
    """(corpus, the JAX DenseIndex, the JAX IVFIndex): test_ivf.py's
    `built` fixture, or its capacity-mode case at the same size."""
    rng = np.random.default_rng(7)
    x = clustered_corpus(rng, N, D)
    jd = JDenseIndex(JIndexConfig(dim=D, matryoshka_dims=(),
                                  initial_capacity=1024,
                                  store_bf16=store_bf16))
    jd.insert(x)
    return x, jd, JIVFIndex.build(jd, **BUILD)


def tcfg(store_bf16=True):
    return IndexConfig(dim=D, matryoshka_dims=(), initial_capacity=1024,
                       store_bf16=store_bf16)


def queries(x, seed, n=64):
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], n, replace=False)
    return (x[idx] + 0.05 * rng.standard_normal((n, x.shape[1])).astype(
        np.float32)).astype(np.float32)


def both(jivf, tivf_, q, k, probes, rescore, filter_mask=None):
    jv, ji = jivf.search(q, k, params=JParams(probes=probes,
                                              rescore=rescore),
                         filter_mask=filter_mask)
    tv, ti = tivf_.search(q, k, params=IVFSearchParams(probes=probes,
                                                       rescore=rescore),
                          filter_mask=filter_mask)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


RESCORE_ATOL = 1e-6


def near_tie(jv, ji, p, tid):
    """The port's id ``tid`` at position ``p`` of a row the reference
    ranked (``jv``, ``ji``) sits in a run of reference scores within
    2 * RESCORE_ATOL of the score at ``p``: where the reference has it,
    or past its last position."""
    at = np.nonzero(ji == tid)[0]
    other = jv[at[0]] if len(at) else jv[-1]
    return abs(other - jv[p]) <= 2 * RESCORE_ATOL


def assert_same_search(j, t, rescore):
    """int8 stage: ids and scores bit-equal. Rescored: scores within
    RESCORE_ATOL, ids equal but where two candidates' exact scores are
    that close (the f32 dot sums in another order than XLA's, so such
    a pair may swap)."""
    (jv, ji), (tv, ti) = j, t
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    if not rescore:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
        return
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=RESCORE_ATOL)
    for r, p in zip(*np.nonzero(ti != ji)):
        assert near_tie(jv[r], ji[r], p, ti[r, p]), (r, p, tv[r], jv[r])


def all_buckets(jivf):
    return int(jivf.bucket_rowids.shape[0])


# ----------------------------------------------------------- search parity

@pytest.mark.parametrize("rescore", [False, True])
@pytest.mark.parametrize("probes", [8, 32, "all"])
def test_search_matches_reference(tmp_path, probes, rescore):
    x, jd, jivf = _reference()
    tivf_ = carry_ivf(jivf, carry_dense(jd, tcfg()), tmp_path)
    p = all_buckets(jivf) if probes == "all" else probes
    q = queries(x, 11)
    j, t = both(jivf, tivf_, q, 10, p, rescore)
    assert_same_search(j, t, rescore)
    assert (t[1][:, 0] != INVALID_ID).all()


@pytest.mark.parametrize("rescore", [False, True])
def test_tail_filter_and_tombstones_match(tmp_path, rescore):
    """Rows inserted after the build (the exact-scanned tail), a payload
    filter, and tombstones on both sides of the partition."""
    x, _, _ = _reference()
    rng = np.random.default_rng(7)
    jd = JDenseIndex(JIndexConfig(dim=D, matryoshka_dims=(),
                                  initial_capacity=1024))
    jd.insert(clustered_corpus(rng, N, D))
    jivf = JIVFIndex.build(jd, **BUILD)
    extra = clustered_corpus(np.random.default_rng(8), 300, D)
    jd.insert(extra)
    dead = np.concatenate([np.arange(0, N, 97), N + np.arange(0, 300, 7)])
    jd.delete(dead)
    tivf_ = carry_ivf(jivf, carry_dense(jd, tcfg()), tmp_path)
    assert tivf_.tail_rows == jivf.tail_rows == 300
    assert tivf_.needs_rebuild == jivf.needs_rebuild
    mask = np.zeros(jd.capacity, dtype=bool)
    mask[::3] = True
    q = np.concatenate([queries(x, 12, 32), extra[:32]])
    for fm in (None, mask):
        for probes in (8, all_buckets(jivf)):
            j, t = both(jivf, tivf_, q, 10, probes, rescore, filter_mask=fm)
            assert_same_search(j, t, rescore)
            ids = t[1][t[1] != INVALID_ID]
            assert not np.isin(ids, dead).any()
            if fm is not None:
                assert mask[ids].all()
    # the tail rows are found without a rebuild
    _, ti = tivf_.search(extra[:32], 1, params=IVFSearchParams(probes=8))
    ok = ~np.isin(N + np.arange(32), dead)
    assert (ti.numpy()[ok, 0] == N + np.arange(32)[ok]).all()


@pytest.mark.parametrize("rescore", [False, True])
def test_capacity_mode_matches(tmp_path, rescore):
    """int8 only, per-row scale: the int8 dots rescale by each row's
    factor before ranking, and the rescore reads the int8 plane."""
    x, jd, jivf = _reference(store_bf16=False)
    td = carry_dense(jd, tcfg(store_bf16=False))
    assert td.vecs is None and td.int8_recip is not None
    tivf_ = carry_ivf(jivf, td, tmp_path)
    q = queries(x, 13)
    for probes in (8, 32, all_buckets(jivf)):
        j, t = both(jivf, tivf_, q, 10, probes, rescore)
        assert_same_search(j, t, rescore)


def test_port_build_matches_reference_build():
    """The port's k-means over the same rows: the same seeded sample and
    initial centroids, then centroids within 1e-5 of the reference's but
    at one near-tie, and the same assignment of every row, so the same
    bucket layout.

    The near-tie: in the eighth (last) iteration, training row 13346
    scores two centroids (9 and 89) one f32 ulp apart (gap 5.96e-8). The
    XLA-CPU and PyTorch f32 products round those two scores differently
    (the centroids themselves agree to 9e-8 after seven iterations), so
    the row joins cluster 9 in the reference and 89 here, and those two
    centroids move by ~1e-3. No other row flips in any iteration, and the
    final assignment of every row is equal. So at most 2 centroids may
    sit past 1e-5; the layout is held equal."""
    _, jd, jivf = _reference()
    tivf_ = IVFIndex.build(carry_dense(jd, tcfg()), **BUILD)
    diff = np.abs(tivf_.centroids.numpy()
                  - np.asarray(jivf.centroids)).max(axis=1)
    assert (diff > 1e-5).sum() <= 2, np.nonzero(diff > 1e-5)
    assert diff.max() < 2e-3
    np.testing.assert_array_equal(tivf_.bucket_cluster.numpy(),
                                  np.asarray(jivf.bucket_cluster))
    np.testing.assert_array_equal(tivf_.bucket_rowids.numpy(),
                                  np.asarray(jivf.bucket_rowids))
    np.testing.assert_array_equal(tivf_.bucket_tbl.numpy(),
                                  np.asarray(jivf.bucket_tbl))
    assert tivf_._build_kw == jivf._build_kw
    assert tivf_.built_n == jivf.built_n == N


def test_kmeans_matches_reference_iteration_by_iteration():
    """The reference's `_kmeans_device` and the port's `_kmeans` on the
    same training rows and initial centroids (the reference's
    normalized sample): after 1-7 iterations every centroid agrees to
    1e-6, before the one near-tie of the test above."""
    import jax.numpy as jnp

    from rag_application_tpu.index.ivf import _kmeans_device

    _, jd, _ = _reference()
    jt = jnp.asarray(jd.vecs)[:N].astype(jnp.float32)
    jt = jt / jnp.maximum(jnp.linalg.norm(jt, axis=-1, keepdims=True), 1e-12)
    jt = jnp.concatenate([jt, jnp.zeros((-N % 4096, D), jnp.float32)])
    init = np.random.default_rng(0).choice(N, size=128, replace=False)
    x = np.array(jt)
    for iters in (1, 4, 7):
        want = np.asarray(_kmeans_device(jt, jt[init], np.int32(N),
                                         n_clusters=128, iters=iters,
                                         block_rows=4096))
        got = tivf._kmeans(torch.from_numpy(x), torch.from_numpy(x[init]),
                           N, n_clusters=128, iters=iters,
                           block_rows=4096).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_kmeans_pads_count_for_nothing():
    """A training set padded past its rows (n_train not a block
    multiple) and an empty cluster: the reference's `_kmeans_device`
    against the port's `_kmeans` on the same inputs."""
    from rag_application_tpu.index.ivf import _kmeans_device

    rng = np.random.default_rng(3)
    x = clustered_corpus(rng, 300, 16, n_clusters=4)
    x = np.concatenate([x, np.zeros((212, 16), np.float32)])
    init = x[:6].copy()
    init[5] = -x[0]  # a centroid no row will choose
    want = np.asarray(_kmeans_device(x, init, np.int32(300), n_clusters=6,
                                     iters=4, block_rows=128))
    got = tivf._kmeans(torch.from_numpy(x), torch.from_numpy(init), 300,
                       n_clusters=6, iters=4, block_rows=128).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[5], init[5] / np.linalg.norm(init[5]))


# ------------------------------------------------------------ persistence

def test_files_cross_packages(tmp_path):
    """JAX file -> port (the carried index above), and port file -> JAX:
    the reloaded reference answers as the original."""
    x, jd, jivf = _reference()
    tivf_ = carry_ivf(jivf, carry_dense(jd, tcfg()), tmp_path)
    path = str(tmp_path / "port.npz")
    tivf_.save(path)
    back = JIVFIndex.load(path, jd)
    assert back.built_n == jivf.built_n
    assert back._build_kw == jivf._build_kw
    with np.load(path) as a, np.load(str(tmp_path / "ivf.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    q = queries(x, 14, 16)
    for rescore in (False, True):
        v1, i1 = jivf.search(q, 5, params=JParams(probes=16,
                                                  rescore=rescore))
        v2, i2 = back.search(q, 5, params=JParams(probes=16,
                                                  rescore=rescore))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


# --------------------------------------------------- layout and exactness

@pytest.mark.parametrize("rescore", [False, True])
def test_chunked_probes_answer_as_one_chunk(tmp_path, monkeypatch, rescore):
    """Chunks of 3 probes over 32 leave 1 padding probe (masked), chunks
    of 1 none: both answer bit for bit as the reference's one chunk."""
    x, jd, jivf = _reference()
    tivf_ = carry_ivf(jivf, carry_dense(jd, tcfg()), tmp_path)
    q = queries(x, 15, 16)
    j, _ = both(jivf, tivf_, q, 10, 32, rescore)
    for per_chunk in (3, 1):
        monkeypatch.setattr(tivf, "SLAB_TEMP_BYTES",
                            per_chunk * 16 * 32 * D * 4)
        tv, ti = tivf_.search(q, 10, params=IVFSearchParams(
            probes=32, rescore=rescore))
        assert_same_search(j, (tv.numpy(), ti.numpy()), rescore)


@pytest.mark.parametrize("d", [1024, 1100, 2100])
def test_int8_dots_exact_past_one_piece(d):
    """Largest-magnitude rows: every dot is the exact integer."""
    rng = np.random.default_rng(d)
    a = rng.choice([-127, 127, -1, 0, 126], size=(3, 40, d)).astype(np.int8)
    b = rng.choice([-127, 127, 5], size=(3, d)).astype(np.int8)
    a[0, 0] = 127
    b[0] = 127
    want = np.einsum("qmd,qd->qm", a.astype(np.int64), b.astype(np.int64))
    got = tivf._int8_mm(torch.from_numpy(a),
                        torch.from_numpy(b)[:, :, None])[..., 0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 127 * 127 * d


def test_wide_rows_match_reference(tmp_path):
    """d 1100: the int8 dots run as two f32 pieces added in int32."""
    rng = np.random.default_rng(21)
    d = 1100
    x = clustered_corpus(rng, 1024, d, n_clusters=8)
    jd = JDenseIndex(JIndexConfig(dim=d, matryoshka_dims=(),
                                  initial_capacity=1024))
    jd.insert(x)
    jivf = JIVFIndex.build(jd, n_clusters=16, bucket_rows=16, iters=3,
                           block_rows=1024)
    tivf_ = carry_ivf(jivf, carry_dense(jd, IndexConfig(
        dim=d, matryoshka_dims=(), initial_capacity=1024)), tmp_path)
    q = queries(x, 22, 8)
    for rescore in (False, True):
        j, t = both(jivf, tivf_, q, 5, 6, rescore)
        assert_same_search(j, t, rescore)


def test_search_reads_the_planes_afresh(tmp_path):
    """A pin makes the next write copy every plane: the index must see
    the copies (new tail rows, tombstones), not the planes of its
    build."""
    x, jd, jivf = _reference()
    td = carry_dense(jd, IndexConfig(dim=D, matryoshka_dims=(),
                                     initial_capacity=1024))
    tivf_ = carry_ivf(jivf, td, tmp_path)
    int8_at_build = td.int8
    td.pin()
    extra = clustered_corpus(np.random.default_rng(9), 4, D)
    rows = td.insert(extra)
    assert td.int8 is not int8_at_build
    _, ti = tivf_.search(extra, 1, params=IVFSearchParams(probes=8))
    assert (ti.numpy()[:, 0] == rows).all()
    td.pin()
    td.delete(rows[:2])
    _, ti = tivf_.search(extra, 1, params=IVFSearchParams(probes=8))
    assert not np.isin(ti.numpy()[:, 0], rows[:2]).any()


# ------------------------------------------- tests/test_ivf.py, the port

@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    x = clustered_corpus(rng, N, D)
    idx = DenseIndex(tcfg(), device="cpu")
    idx.insert(x)
    return rng, x, idx, IVFIndex.build(idx, **BUILD)


def recall_of(ids, exact):
    return np.mean([np.isin(exact[i], ids[i]).mean()
                    for i in range(len(exact))])


def test_recall_meets_bar_on_clustered(built):
    rng, x, idx, ivf = built
    q_idx = rng.choice(N, 64, replace=False)
    q = x[q_idx] + 0.05 * rng.standard_normal((64, D)).astype(np.float32)
    exact = np.argsort(-(q @ x.T), axis=-1)[:, :10]
    vals, ids = ivf.search(q, 10, params=IVFSearchParams(probes=48))
    ids, vals = ids.numpy(), vals.numpy()
    assert recall_of(ids, exact) >= 0.95
    assert np.mean([q_idx[i] in ids[i] for i in range(64)]) >= 0.95
    assert (np.diff(vals, axis=-1) <= 1e-6).all()
    assert vals.max() <= 1.01


def test_probes_is_the_recall_knob(built):
    rng, x, idx, ivf = built
    q_idx = rng.choice(N, 64, replace=False)
    q = x[q_idx] + 0.05 * rng.standard_normal((64, D)).astype(np.float32)
    exact = np.argsort(-(q @ x.T), axis=-1)[:, :10]

    def recall(probes):
        _, ids = ivf.search(q, 10, params=IVFSearchParams(probes=probes))
        return recall_of(ids.numpy(), exact)

    r_low, r_high = recall(4), recall(64)
    assert r_high >= r_low and r_high >= 0.95


def test_bucket_coverage_complete(built):
    _, x, idx, ivf = built
    rid = ivf.bucket_rowids.numpy()
    cov = rid[rid >= 0]
    assert len(np.unique(cov)) == N and len(cov) == len(np.unique(cov))


def test_tail_rows_findable_without_rebuild(built):
    rng, x, idx, ivf = built
    extra = clustered_corpus(rng, 16, D)
    rows = idx.insert(extra)
    try:
        _, ids = ivf.search(extra, 3, params=IVFSearchParams(probes=8))
        assert (ids.numpy()[:, 0] == rows).all()
        assert ivf.tail_rows == 16 and not ivf.needs_rebuild
    finally:
        idx.delete(rows)


def test_rebuild_folds_tail(built):
    rng, x, idx, ivf = built
    extra = clustered_corpus(rng, 8, D)
    rows = idx.insert(extra)
    try:
        ivf.rebuild(n_clusters=128, iters=4, block_rows=4096)
        assert ivf.tail_rows == 0
        _, ids = ivf.search(extra, 1, params=IVFSearchParams(probes=32))
        assert (ids.numpy()[:, 0] == rows).all()
    finally:
        idx.delete(rows)
        ivf.rebuild(n_clusters=128, iters=4, block_rows=4096)


def test_filter_mask_and_tombstones(built):
    rng, x, idx, ivf = built
    mask = np.zeros(idx.capacity, dtype=bool)
    mask[1000:2000] = True
    vals, ids = ivf.search(x[:4], 5, params=IVFSearchParams(probes=64),
                           filter_mask=mask)
    ok = ids.numpy()[np.isfinite(vals.numpy())]
    assert ((ok >= 1000) & (ok < 2000)).all()


def small_collection_config(dim, cap):
    cfg = Config()
    cfg.index = IndexConfig(dim=dim, matryoshka_dims=(), initial_capacity=cap)
    return cfg


def test_collection_integration():
    rng = np.random.default_rng(3)
    col = Collection("user_ivf", small_collection_config(32, 64),
                     device="cpu")
    x = clustered_corpus(rng, 512, 32, n_clusters=8)
    col.store_document_vectors("doc", [{"text": f"chunk {i}"}
                                       for i in range(512)], x)
    col.build_ann(n_clusters=16, bucket_rows=16, iters=4, block_rows=256)
    assert isinstance(col.ann, IVFIndex)
    hits = col.ann_search(x[37], limit=3, ef=8)
    assert hits and hits[0].row == 37


def test_capacity_mode_int8_only():
    rng = np.random.default_rng(5)
    x = clustered_corpus(rng, 4096, 32, n_clusters=16)
    idx = DenseIndex(IndexConfig(dim=32, matryoshka_dims=(),
                                 initial_capacity=1024, store_bf16=False),
                     device="cpu")
    idx.insert(x)
    ivf = IVFIndex.build(idx, n_clusters=32, bucket_rows=16, iters=4,
                         block_rows=1024)
    vals, ids = ivf.search(x[:16], 3, params=IVFSearchParams(probes=16))
    assert (ids.numpy()[:, 0] == np.arange(16)).all()
    assert vals.numpy().max() <= 1.05


def test_save_load_roundtrip(built, tmp_path):
    rng, x, idx, ivf = built
    path = str(tmp_path / "ivf.npz")
    ivf.save(path)
    restored = IVFIndex.load(path, idx)
    v1, i1 = ivf.search(x[:8], 5, params=IVFSearchParams(probes=16))
    v2, i2 = restored.search(x[:8], 5, params=IVFSearchParams(probes=16))
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    assert restored._build_kw == ivf._build_kw


# -------------------------------- tests/test_ann_integration.py, the port

def ann_config(cls, index, sparse, funnel):
    cfg = cls()
    cfg.index = index(dim=32, matryoshka_dims=(8, 16), initial_capacity=512,
                      block_size=256)
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    return cfg


@functools.lru_cache(maxsize=None)
def ann_cols():
    """(JAX collection, port collection, embeddings): the same rows and
    payloads; the port searches the reference's dense tables and IVF
    file."""
    from rag_application_tpu.config import FunnelConfig as JF
    from rag_application_tpu.config import SparseConfig as JS

    rng = np.random.default_rng(1234)
    embs = rng.standard_normal((300, 32)).astype(np.float32)
    chunks = [{"text": f"chunk {i}", "tag": "a" if i % 2 == 0 else "b"}
              for i in range(300)]
    jcol = JCollection("ann", ann_config(JConfig, JIndexConfig, JS, JF))
    tcol = Collection("ann", ann_config(Config, IndexConfig, SparseConfig,
                                        FunnelConfig), device="cpu")
    for col in (jcol, tcol):
        col.store_document_vectors("d1", chunks, embs)
        col.build_ann(n_clusters=16, bucket_rows=16, iters=4,
                      block_rows=256)
    return jcol, tcol, embs


def test_collection_ann_search():
    jcol, c, embs = ann_cols()
    rng = np.random.default_rng(0)
    q = embs[42] + 0.01 * rng.standard_normal(32).astype(np.float32)
    hits = c.ann_search(q, limit=5, ef=48)
    assert hits[0].row == 42 and hits[0].payload["text"] == "chunk 42"


def test_collection_ann_filter():
    jcol, c, embs = ann_cols()
    hits = c.ann_search(embs[10], limit=5, ef=48, tag="b")
    assert hits and all(h.payload["tag"] == "b" for h in hits)


def test_ivf_index_save_load(tmp_path):
    jcol, c, embs = ann_cols()
    path = str(tmp_path / "ivf.npz")
    c.ann.save(path)
    restored = IVFIndex.load(path, c.dense)
    v1, i1 = c.ann.search(embs[:3], 4)
    v2, i2 = restored.search(embs[:3], 4)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())


@pytest.mark.parametrize("filters", [{}, {"tag": "b"}, {"tag": "a"},
                                     {"document_id": "d1"},
                                     {"document_id": "other"}])
def test_ann_search_hits_match_reference(tmp_path, filters):
    """`Collection.ann_search` in both packages over the same tables and
    IVF file: the same rows and payloads, scores within 1e-6."""
    jcol, _, embs = ann_cols()
    tcol = Collection("ann", ann_config(Config, IndexConfig, SparseConfig,
                                        FunnelConfig), device="cpu")
    tcol.store_document_vectors(
        "d1", [{"text": f"chunk {i}", "tag": "a" if i % 2 == 0 else "b"}
               for i in range(300)], embs)
    tcol.dense = carry_dense(jcol.dense, tcol.cfg.index)
    tcol.ann = carry_ivf(jcol.ann, tcol.dense, tmp_path)
    rng = np.random.default_rng(5)
    for i in (3, 42, 299):
        q = embs[i] + 0.05 * rng.standard_normal(32).astype(np.float32)
        for ef in (4, 48):
            jh = jcol.ann_search(q, limit=5, ef=ef, **filters)
            th = tcol.ann_search(q, limit=5, ef=ef, **filters)
            assert [(h.row, h.payload) for h in th] == \
                [(h.row, h.payload) for h in jh]
            np.testing.assert_allclose([h.score for h in th],
                                       [h.score for h in jh], rtol=0,
                                       atol=1e-6)
    assert bool(th) == (filters.get("document_id") != "other")


def test_ann_entry_points_raise_as_the_reference():
    for col in (JCollection("e", ann_config(JConfig, JIndexConfig,
                                            *_jcfg_parts())),
                Collection("e", ann_config(Config, IndexConfig, SparseConfig,
                                           FunnelConfig), device="cpu")):
        with pytest.raises(RuntimeError, match="build_ann"):
            col.ann_search(np.zeros(32, np.float32))
        with pytest.raises(ValueError, match="empty index"):
            col.build_ann()
        with pytest.raises(ValueError, match="unknown ANN engine"):
            col.build_ann(engine="hnsw")


def _jcfg_parts():
    from rag_application_tpu.config import FunnelConfig as JF
    from rag_application_tpu.config import SparseConfig as JS
    return JS, JF
