"""Parity of the port's corpus-axis sharding (`parallel/{mesh,sparse,
search,ivf}.py`) with the JAX package's, on the CPU: the port at
``make_mesh(8, devices=[cpu] * 8)`` against the reference at
``make_mesh(8)`` (8 virtual XLA devices, tests/conftest.py), on the same
numpy data. Each case of tests/test_parallel.py has its counterpart here,
apart from the `__graft_entry__` contract tests.

  * ids equal, values within 1e-5 (the sharded funnel scores its union
    with the same f32 dot as the reference, summed in another order);
  * `build_sharded_sparse`'s arrays equal to the reference's;
  * the 100k x 64 sharded funnel equal to the port's own single-device
    `fused_core` with the same spec, and to the reference's sharded one;
  * IVF: the reference's stacked build carried into the port, searched
    with and without the exact rescore and in capacity mode (per-row
    recip): int8-stage ids and scores bit-equal; rescored ids equal but
    at near-ties (two exact f32 scores within 2e-6) and scores within
    1e-6, as tests/test_torch_ivf.py holds the single-device engine. The
    port's own build is held to the reference test's recall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.index.dense import DenseIndex as JDenseIndex
from rag_application_tpu.index.sparse import SparseIndex as JSparseIndex
from rag_application_tpu.parallel import ivf as jivf
from rag_application_tpu.parallel import mesh as jmesh
from rag_application_tpu.parallel import search as jsearch
from rag_application_tpu.parallel import sparse as jsparse
from rag_application_tpu.search.fused import FusedSpec as JFusedSpec
from rag_application_tpu_torch.config import IndexConfig, SparseConfig
from rag_application_tpu_torch.index.dense import DenseIndex
from rag_application_tpu_torch.index.sparse import SparseIndex
from rag_application_tpu_torch.ops.rrf import INVALID_ID
from rag_application_tpu_torch.parallel import ivf as tivf
from rag_application_tpu_torch.parallel import mesh as tmesh
from rag_application_tpu_torch.parallel import search as tsearch
from rag_application_tpu_torch.parallel import sparse as tsparse
from rag_application_tpu_torch.search.fused import FusedSpec, fused_core

CPU8 = [torch.device("cpu")] * 8
ATOL = 1e-5


def tmesh8(**kw):
    return tmesh.make_mesh(8, devices=CPU8, **kw)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(t, j, atol=ATOL):
    """Port (vals, ids) equal to the reference's: ids exact, finite
    values within ``atol``, -inf where the reference has -inf."""
    (tv, ti), (jv, ji) = [(np_(v), np_(i)) for v, i in (t, j)]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=atol)


# ----------------------------------------------------------------- mesh

@pytest.mark.parametrize("n, kw, want", [
    (8, dict(model=2), {"data": 4, "model": 2}),
    (8, {}, {"data": 8, "model": 1}),
    (6, dict(data=3, model=2), {"data": 3, "model": 2}),
    (4, dict(model=4), {"data": 1, "model": 4}),
])
def test_make_mesh_shapes(n, kw, want):
    mesh = tmesh.make_mesh(n, devices=CPU8, **kw)
    assert mesh.shape == want == dict(jmesh.make_mesh(n, **kw).shape)
    assert mesh.first == torch.device("cpu")
    assert len(mesh.axis_devices("data")) == want["data"]
    assert len(mesh.axis_devices("model")) == want["model"]


@pytest.mark.parametrize("n, kw", [(8, dict(model=3)),
                                   (None, dict(data=5, model=2))])
def test_make_mesh_raises_like_reference(n, kw):
    with pytest.raises(ValueError):
        jmesh.make_mesh(n, **kw)
    with pytest.raises(ValueError):
        tmesh.make_mesh(n, devices=CPU8, **kw)


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tmesh.make_mesh().first.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()


def _spec_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_shardings_rules(model):
    params = {"kernel": np.zeros((16, 64)), "bias": np.zeros((7,)),
              "odd": np.zeros((3, 5)),
              "nested": {"emb": np.zeros((96, 8)), "sq": np.zeros((6, 6)),
                         "t3": np.zeros((2, 12, 3))}}
    jm = jmesh.make_mesh(8, model=model)
    tm = tmesh.make_mesh(8, model=model, devices=CPU8)
    want = jax.tree.map(lambda s: _spec_dim(s.spec),
                        jmesh.param_shardings(jm, jax.tree.map(
                            jnp.asarray, params)),
                        is_leaf=lambda x: isinstance(x, NamedSharding))
    assert tmesh.param_shardings(tm, params) == want
    if model == 2:
        assert want["kernel"] == 1 and want["bias"] is None
        assert want["odd"] is None


def test_sharding_descriptors():
    mesh = tmesh8()
    assert tmesh.replicated(mesh) is None
    assert tmesh.batch_sharding(mesh) == "data"
    assert tmesh.row_sharding(mesh, "model") == "model"
    with pytest.raises(ValueError):
        tmesh.row_sharding(mesh, "shard")


# ------------------------------------------------------------ sharded top-k

@pytest.mark.parametrize("approx", [False, True])
def test_sharded_topk_matches_single_device(rng, approx):
    n, d, q, k = 8 * 64, 32, 6, 7
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = corpus[:q] + 0.05 * rng.standard_normal((q, d)).astype(
        np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)

    jm = jmesh.make_mesh(8)
    want = jsearch.sharded_topk(jm, jsearch.shard_corpus(jm, corpus),
                                jnp.asarray(queries), k, valid_n=n,
                                approx=approx)
    tm = tmesh8()
    got = tsearch.sharded_topk(tm, tsearch.shard_corpus(tm, corpus),
                               torch.from_numpy(queries), k, valid_n=n,
                               approx=approx)
    assert_same(got, want)
    ref = np.argsort(-(queries @ corpus.T), axis=-1)[:, :k]
    np.testing.assert_array_equal(np_(got[1]), ref)
    # a whole array is placed first, the same answer
    assert_same(tsearch.sharded_topk(tm, corpus, torch.from_numpy(queries),
                                     k, valid_n=n, approx=approx), want)


def test_sharded_topk_ragged_tail(rng):
    """Logical size not divisible by shard count: padding rows excluded."""
    n_logical, d, k = 100, 16, 5
    corpus = rng.standard_normal((n_logical, d)).astype(np.float32)
    queries = corpus[:3]
    jm, tm = jmesh.make_mesh(8), tmesh8()
    want = jsearch.sharded_topk(jm, jsearch.shard_corpus(jm, corpus),
                                jnp.asarray(queries), k,
                                valid_n=n_logical, approx=False)
    shards = tsearch.shard_corpus(tm, corpus)          # pads to 104 rows
    assert [s.shape[0] for s in shards] == [13] * 8
    got = tsearch.sharded_topk(tm, shards, torch.from_numpy(queries), k,
                               valid_n=n_logical, approx=False)
    assert_same(got, want)
    assert np_(got[1]).max() < n_logical
    assert (np_(got[1])[:, 0] == np.arange(3)).all()


def test_sharded_hybrid_topk_matches_reference(rng):
    n, d, q, k = 8 * 32, 64, 4, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = corpus[:q] + 0.01 * rng.standard_normal((q, d)).astype(
        np.float32)
    int8 = np.clip(np.round(corpus * 127), -127, 127).astype(np.int8)
    jm, tm = jmesh.make_mesh(8), tmesh8()
    rows = NamedSharding(jm, P("data", None))
    want = jsearch.sharded_hybrid_topk(
        jm, jax.device_put(jnp.asarray(corpus), rows),
        jax.device_put(jnp.asarray(int8), rows), jnp.asarray(queries), k,
        candidates=8, block_size=32)
    got = tsearch.sharded_hybrid_topk(
        tm, tsearch.shard_corpus(tm, corpus), tmesh.shard_rows(tm, int8),
        torch.from_numpy(queries), k, candidates=8, block_size=32)
    assert_same(got, want)


def test_dryrun_helper():
    tsearch.sharded_topk_dryrun(tmesh8())


# ---------------------------------------------------------- sharded funnel

def _funnel_data(rng):
    """tests/test_parallel.py's full-funnel corpus, texts and queries."""
    n, d = 96, 32
    words = ("fox dog tensor unit sparse dense graph node query index "
             "rank fusion chunk page entity relation").split()
    corpus = (rng.standard_normal((n, d))
              * np.exp(-0.02 * np.arange(d))).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    texts = [" ".join(rng.choice(words, size=6)) for _ in range(n)]
    texts[77] = "zebra quagga okapi zebra quagga"  # lexical-only target
    q_idx = np.array([3, 42, 77, 90])
    queries = corpus[q_idx] + 0.01 * rng.standard_normal(
        (len(q_idx), d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    return corpus, texts, q_idx, queries


def _both_sparse(texts, **cfg):
    js = JSparseIndex(JSparseConfig(**cfg))
    ts = SparseIndex(SparseConfig(**cfg), device="cpu")
    js.add_batch(texts)
    ts.add_batch(texts)
    return js, ts


def test_build_sharded_sparse_arrays_equal(rng):
    words = "alpha beta gamma delta epsilon zeta eta theta iota".split()
    texts = [" ".join(rng.choice(words, size=int(rng.integers(1, 12))))
             for _ in range(203)]
    js, ts = _both_sparse(texts, candidate_pool=32, max_query_terms=8)
    for shards in (1, 4, 8):
        want = jsparse.build_sharded_sparse(js, shards)
        got = tsparse.build_sharded_sparse(ts, shards)
        assert set(got) == set(want)
        for key in ("rows_per_shard", "v_pad", "p", "l"):
            assert got[key] == want[key], key
        for key in ("post_packed", "doc_packed"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="empty"):
        tsparse.build_sharded_sparse(
            SparseIndex(SparseConfig(), device="cpu"), 4)


@pytest.mark.parametrize("mode", ["dense", "capacity", "filter",
                                  "no_sparse"])
def test_sharded_fused_hybrid_matches_reference(rng, mode):
    """The FULL hybrid funnel (int8 scan + local BM25 + exact rescore)
    over 8 shards, the reference test's setting: the port's merged ids
    equal the reference's; with per-shard-exact limits the result holds
    the exact dense oracle, lexical-only docs surface, and capacity mode
    (vecs=None) keeps the top hits. ``filter`` masks a third of the rows;
    ``no_sparse`` drops the postings."""
    corpus, texts, q_idx, queries = _funnel_data(rng)
    n, d = corpus.shape
    js, ts = _both_sparse(texts, candidate_pool=64, max_query_terms=8)
    sh = jsparse.build_sharded_sparse(js, 8)
    r = sh["rows_per_shard"]
    pad = 8 * r - n
    vecs = np.pad(corpus, ((0, pad), (0, 0)))
    int8 = np.clip(np.round(vecs * 127), -127, 127).astype(np.int8)
    live = np.zeros(8 * r, dtype=bool)
    live[:n] = True
    fmask = None
    if mode == "filter":
        fmask = np.arange(8 * r) % 3 != 1
    sparse_on = mode != "no_sparse"
    q_rows, q_terms, q_valid = js.encode_queries([texts[i] for i in q_idx])
    k = 10
    kw = dict(quantized_limit=r, dense_limit=r, sparse_limit=8,
              sparse_pool=64, block_size=32)

    jm = jmesh.make_mesh(8)
    rows = NamedSharding(jm, P("data", None))
    flat = NamedSharding(jm, P("data"))
    stack = NamedSharding(jm, P("data", None, None))
    want = jsearch.sharded_fused_hybrid(
        jm, None if mode == "capacity" else jax.device_put(
            jnp.asarray(vecs), rows),
        jax.device_put(jnp.asarray(int8), rows), None,
        jax.device_put(jnp.asarray(live), flat),
        jax.device_put(jnp.asarray(sh["post_packed"]), stack)
        if sparse_on else None,
        jax.device_put(jnp.asarray(sh["doc_packed"]), stack)
        if sparse_on else None,
        jnp.asarray(queries), q_rows, q_terms, q_valid, k,
        filter_mask=(None if fmask is None
                     else jax.device_put(jnp.asarray(fmask), flat)), **kw)

    tm = tmesh8()
    tq = ts.encode_queries([texts[i] for i in q_idx])
    for a, b in zip(tq, (q_rows, q_terms, q_valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tsh = tsparse.build_sharded_sparse(ts, 8)
    got = tsearch.sharded_fused_hybrid(
        tm, None if mode == "capacity" else vecs, int8, None, live,
        tsh["post_packed"] if sparse_on else None,
        tsh["doc_packed"] if sparse_on else None,
        torch.from_numpy(queries), *tq, k, filter_mask=fmask, **kw)
    assert_same(got, want)

    vals, ids = np_(got[0]), np_(got[1])
    assert ids.dtype == np.int32 and vals.dtype == np.float32
    if mode == "dense":
        exact = np.argsort(-(queries @ corpus.T), axis=-1)[:, :k]
        recall = np.mean([np.isin(exact[i], ids[i]).mean()
                          for i in range(len(q_idx))])
        assert recall == 1.0, recall
        assert (ids[:, 0] == q_idx).all()
        assert (np.diff(vals, axis=-1) <= 1e-6).all()
    if mode == "capacity":
        assert (ids[:, 0] == q_idx).all()
        assert np.all(vals[np.isfinite(vals)] <= 1.02)
    if mode == "filter":
        hit = ids[ids != INVALID_ID]
        assert fmask[hit].all()


def test_sharded_sparse_scores_match_host_oracle(rng):
    """Per-shard BM25 with global stats reproduces the exact host scores
    for every returned doc (sharding must never change a score), through
    the port's `bm25_topk` on each shard's arrays."""
    from rag_application_tpu_torch.ops.bm25 import bm25_topk

    words = "alpha beta gamma delta epsilon zeta eta theta".split()
    sparse = SparseIndex(SparseConfig(candidate_pool=32, max_query_terms=8),
                         device="cpu")
    texts = [" ".join(rng.choice(words, size=5)) for _ in range(40)]
    sparse.add_batch(texts)
    sh = tsparse.build_sharded_sparse(sparse, 4)
    r = sh["rows_per_shard"]

    query = "alpha delta"
    q_rows, q_terms, q_valid = sparse.encode_queries([query])
    oracle = sparse.exact_scores(query)

    found = {}
    for s in range(4):
        scores, ids = bm25_topk(
            torch.from_numpy(sh["post_packed"][s]), None,
            torch.from_numpy(sh["doc_packed"][s]),
            q_rows, q_terms, q_valid, r, pool=32, approx=False)
        for score, lid in zip(scores.numpy()[0], ids.numpy()[0]):
            if np.isfinite(score):
                found[s * r + int(lid)] = float(score)
    assert found, "no sparse hits"
    for gid, score in found.items():
        np.testing.assert_allclose(score, oracle[gid], rtol=1e-4)
    expect = {i for i in range(40) if oracle[i] > 0}
    assert set(found) == expect


def test_sharded_funnel_equals_single_device_at_100k(rng):
    """The sharded funnel runs `fused_core` per shard with the SAME spec
    (matryoshka cascade + int8 + packed-postings BM25), so with per-shard
    limits == single-device limits every single-device candidate is
    found by its shard and the merged top-k equals the port's
    single-device `fused_core` (the reference's scan engine, "xla"):
    ids exact, scores within 1e-5 — and equals the reference's sharded
    funnel on the same data."""
    n, d, nq, k = 100_000, 64, 8, 10
    dims = (16, 32)
    corpus = (rng.standard_normal((n, d))
              * np.exp(-0.05 * np.arange(d))).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    vecs = torch.from_numpy(corpus).to(torch.bfloat16)
    int8 = np.clip(np.round(corpus * 127), -127, 127).astype(np.int8)
    inv = np.stack(
        [1.0 / np.maximum(np.linalg.norm(corpus[:, :dd], axis=-1), 1e-12)
         for dd in dims], axis=1).astype(np.float32)

    words = [f"tok{i}" for i in range(512)]
    texts = [" ".join(rng.choice(words, size=5)) for _ in range(n)]
    sparse = SparseIndex(SparseConfig(candidate_pool=64, max_query_terms=8),
                         device="cpu")
    for s in range(0, n, 10_000):
        sparse.add_batch(texts[s:s + 10_000])
    q_idx = rng.choice(n, size=nq, replace=False)
    queries = corpus[q_idx] + 0.05 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    tq = sparse.encode_queries([texts[i] for i in q_idx])

    spec = FusedSpec(
        k=k, matryoshka_dims=dims, matryoshka_limits=(48, 32),
        dense_limit=32, quantized_limit=48, sparse_limit=16,
        sparse_pool=64, rrf_k=60, block_size=8192, recall_target=1.0)

    # --- the port, one device ---
    dv = sparse.device_arrays()
    s_vals, s_ids = fused_core(
        vecs, torch.from_numpy(int8), torch.from_numpy(inv),
        torch.ones(n, dtype=torch.bool), n, torch.from_numpy(queries), None,
        (dv["post_docs"], dv["post_weights"], dv["doc_packed"]), tq,
        spec._replace(scan_impl="xla", final_fusion="dense"))

    # --- the port, 8 shards ---
    sh = tsparse.build_sharded_sparse(sparse, 8)
    r = sh["rows_per_shard"]
    pad = 8 * r - n
    tm = tmesh8()
    m_vals, m_ids = tsearch.sharded_fused_hybrid(
        tm, torch.nn.functional.pad(vecs, (0, 0, 0, pad)),
        np.pad(int8, ((0, pad), (0, 0))), np.pad(inv, ((0, pad), (0, 0))),
        np.pad(np.ones(n, bool), (0, pad)), sh["post_packed"],
        sh["doc_packed"], torch.from_numpy(queries), *tq, k, spec=spec,
        valid_n=n)
    assert_same((m_vals, m_ids), (s_vals, s_ids))

    # --- the reference, 8 shards ---
    jm = jmesh.make_mesh(8)
    rows = NamedSharding(jm, P("data", None))
    stack = NamedSharding(jm, P("data", None, None))
    jv = np.pad(corpus, ((0, pad), (0, 0))).astype(jnp.bfloat16)
    want = jsearch.sharded_fused_hybrid(
        jm, jax.device_put(jnp.asarray(jv), rows),
        jax.device_put(jnp.asarray(np.pad(int8, ((0, pad), (0, 0)))), rows),
        jax.device_put(jnp.asarray(np.pad(inv, ((0, pad), (0, 0)))), rows),
        jax.device_put(jnp.asarray(np.pad(np.ones(n, bool), (0, pad))),
                       NamedSharding(jm, P("data"))),
        jax.device_put(jnp.asarray(sh["post_packed"]), stack),
        jax.device_put(jnp.asarray(sh["doc_packed"]), stack),
        jnp.asarray(queries), *[jnp.asarray(x.numpy()) for x in tq], k,
        spec=JFusedSpec(**spec._asdict()), valid_n=n)
    assert_same((m_vals, m_ids), want)


# ------------------------------------------------------------------- IVF

def _clustered(rng, n, d, n_centers):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    x = centers[rng.integers(0, n_centers, n)] + \
        0.25 * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _port_dense(jd, d, store_bf16):
    """The port's DenseIndex holding the reference's tables."""
    from rag_application_tpu_torch import state

    vecs = None if jd.vecs is None else np.asarray(jd.vecs).view(np.uint16)
    arrays = {"vecs": vecs, "int8": np.asarray(jd.int8),
              "inv_norms": np.asarray(jd.inv_norms),
              "int8_recip": (None if jd.int8_recip is None
                             else np.asarray(jd.int8_recip)),
              "live": np.asarray(jd.live), "prefix_int8": None}
    cfg = IndexConfig(dim=d, matryoshka_dims=(), initial_capacity=1024,
                      store_bf16=store_bf16)
    return state.dense_from_numpy(cfg, arrays, jd.size, jd.has_deletes,
                                  device="cpu")


RESCORE_ATOL = 1e-6


def assert_same_ivf(t, j, rescore):
    """int8 stage: ids and scores bit-equal. Rescored: scores within
    RESCORE_ATOL, ids equal but where two candidates' exact scores are
    within 2 RESCORE_ATOL (the f32 dot sums in another order)."""
    (tv, ti), (jv, ji) = [(np_(v), np_(i)) for v, i in (t, j)]
    if not rescore:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
        return
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=RESCORE_ATOL)
    for r, p in zip(*np.nonzero(ti != ji)):
        at = np.nonzero(ji[r] == ti[r, p])[0]
        other = jv[r, at[0]] if len(at) else jv[r, -1]
        assert abs(other - jv[r, p]) <= 2 * RESCORE_ATOL, (r, p)


@pytest.mark.parametrize("capacity", [False, True])
def test_sharded_ivf_matches_reference(rng, capacity):
    """tests/test_parallel.py's IVF cases (40k rows with a bf16 plane;
    16k int8-only rows with per-row scale): the reference's stacked build
    placed on the port's mesh, searched at probes 32 with and without the
    rescore, against the reference's search; the reference test's recall
    and score bounds on the port."""
    n, d, centers = (16_000, 64, 32) if capacity else (40_000, 64, 64)
    build = (dict(n_clusters=16, bucket_rows=16, iters=4, block_rows=512)
             if capacity else
             dict(n_clusters=32, bucket_rows=16, iters=5, block_rows=1024))
    x = _clustered(rng, n, d, centers)
    jd = JDenseIndex(JIndexConfig(dim=d, matryoshka_dims=(),
                                  initial_capacity=1024,
                                  store_bf16=not capacity))
    jd.insert(x)
    jm, tm = jmesh.make_mesh(8), tmesh8()
    stacked = jivf.build_sharded_ivf(jd, 8, **build)
    assert ("bucket_recip" in stacked) == capacity
    jplaced = jivf.place_sharded_ivf(jm, stacked)
    tplaced = tivf.place_sharded_ivf(tm, stacked)
    nq = 32 if capacity else 48
    q = x[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    exact = np.argsort(-(q @ x.T), axis=-1)[:, :10]

    cases = [False] if capacity else [False, True]
    r = stacked["rows_per_shard"]
    for rescore in cases:
        jkw, tkw = {}, {}
        if rescore:
            vs = jnp.pad(jd.vecs[:n].astype(jnp.bfloat16),
                         ((0, 8 * r - n), (0, 0)))
            jkw["rescore_vecs"] = jax.device_put(
                vs, NamedSharding(jm, P("data", None)))
            tkw["rescore_vecs"] = torch.from_numpy(
                np.asarray(vs).view(np.int16)).view(
                torch.bfloat16)
        want = jivf.sharded_ivf_search(jm, jplaced, jnp.asarray(q), 10,
                                       probes=32, **jkw)
        got = tivf.sharded_ivf_search(tm, tplaced, torch.from_numpy(q), 10,
                                      probes=32, **tkw)
        assert_same_ivf(got, want, rescore)
        ids, vals = np_(got[1]), np_(got[0])
        rec = np.mean([np.isin(exact[i], ids[i]).mean() for i in range(nq)])
        if capacity:
            assert rec >= 0.9, rec
            assert vals[np.isfinite(vals)].max() <= 1.1
        elif rescore:
            assert rec >= 0.95, rec
            assert vals.max() <= 1.01
            assert (np.diff(vals, axis=-1) <= 1e-6).all()
        else:
            assert np.isfinite(vals).any()


def test_port_sharded_ivf_build(rng):
    """The port's own `build_sharded_ivf` over the reference test's
    corpus: every row in exactly one bucket of its own shard, global row
    ids, the reference's array layout, and recall@10 >= 0.95 at probes 32
    with the rescore."""
    n, d = 40_000, 64
    x = _clustered(rng, n, d, 64)
    jd = JDenseIndex(JIndexConfig(dim=d, matryoshka_dims=(),
                                  initial_capacity=1024))
    jd.insert(x)
    td = _port_dense(jd, d, True)
    build = dict(n_clusters=32, bucket_rows=16, iters=5, block_rows=1024)
    got = tivf.build_sharded_ivf(td, 8, **build)
    want = jivf.build_sharded_ivf(jd, 8, **build)
    assert set(got) == set(want)
    for key, a in got.items():
        if key != "rows_per_shard":
            assert a.shape == want[key].shape and a.dtype == want[key].dtype
    r = got["rows_per_shard"]
    assert r == want["rows_per_shard"] == n // 8
    for s in range(8):
        rid = got["bucket_rowids"][s]
        rows = np.sort(rid[rid >= 0])
        np.testing.assert_array_equal(rows, np.arange(s * r, (s + 1) * r))
    tm = tmesh8()
    placed = tivf.place_sharded_ivf(tm, got)
    q = x[rng.choice(n, 48, replace=False)] + 0.05 * rng.standard_normal(
        (48, d)).astype(np.float32)
    exact = np.argsort(-(q @ x.T), axis=-1)[:, :10]
    _, ids = tivf.sharded_ivf_search(tm, placed, torch.from_numpy(q), 10,
                                     probes=32, rescore_vecs=td.vecs[:n])
    ids = ids.numpy()
    rec = np.mean([np.isin(exact[i], ids[i]).mean() for i in range(48)])
    assert rec >= 0.95, rec
