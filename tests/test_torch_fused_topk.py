"""Parity of the port's fused scan (`ops.fused_topk`) with the Pallas
kernel, run in interpret mode on the CPU as the JAX suite runs it.

On CPU tensors the port's wrapper takes the kernel's plain version, so
this holds the plain version's sheet — bins, winners, row ids, ties and
sentinels — against the Pallas kernel's for every reduce path. int8
sheets (`select=False`) must be bit-equal; the f32 (bf16 corpus) path
sums in another order, so its values agree to the float32 dot bound and
its ids may differ only between near-tied rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.ops import fused_topk as jf
from rag_application_tpu_torch.ops import fused_topk as tf
from rag_application_tpu_torch.state import bf16_from_bits

# f32 path tolerance: |error| of a d-term f32 dot of unit rows is at most
# d * 2^-24 (~7.6e-6 at d = 128); inv_norms rescaling keeps it O(1e-5)
F32_ATOL = 3e-5


def _setup(rng, path, n, d=None, nq=5):
    """(corpus, queries, inv) numpy inputs of one reduce path."""
    if d is None:
        d = 1024 if path == "int8_general" else 128
    x = (rng.standard_normal((n, d))
         * np.exp(-0.01 * np.arange(d))).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    qs = x[:nq] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    q8 = np.clip(np.round(qs * 127), -127, 127).astype(np.int8)
    if path in ("packed", "int8_general"):
        return np.clip(np.round(x * 127), -127, 127).astype(np.int8), q8, None
    if path == "packed_scaled":  # capacity mode: per-row max-abs scale
        amax = np.abs(x).max(axis=1)
        c8 = np.clip(np.round(x * (127.0 / amax[:, None])), -127, 127)
        return c8.astype(np.int8), q8, (amax / 127.0).astype(np.float32)
    inv = (1.0 / np.linalg.norm(x[:, :64], axis=-1)).astype(np.float32)
    return x, qs, inv  # f32: bf16 corpus + queries below


def _pair(a, bf16):
    """The same array for both packages (bf16 via its bits)."""
    if a is None:
        return None, None
    if bf16:
        j = jnp.asarray(a, jnp.bfloat16)
        return j, bf16_from_bits(np.asarray(j).view(np.uint16), "cpu")
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _run(corpus, queries, inv, mask, k=12, select=False, **kw):
    bf16 = corpus.dtype == np.float32
    jc, tc = _pair(corpus, bf16)
    jq, tq = _pair(queries, bf16)
    ji, ti = _pair(inv, False)
    jm, tm = _pair(mask, False)
    jv, jids = jf.fused_scan_topk(jc, jq, k, inv_norms=ji, mask=jm,
                                  select=select, **kw)
    tv, tids = tf.fused_scan_topk(tc, tq, k, inv_norms=ti, mask=tm,
                                  select=select, **kw)
    assert tf.fused_scan_topk.last_path == jf.fused_scan_topk.last_path
    return (np.asarray(jv), np.asarray(jids), tv.numpy(), tids.numpy(),
            tc, tq, ti)


def _check_f32_sheet(jv, jids, tv, tids, tc, tq, ti, prefix,
                     atol=F32_ATOL):
    np.testing.assert_allclose(tv, jv, rtol=0, atol=atol)
    diff = jids != tids
    if not diff.any():
        return
    # a differing winner must be a near-tie: both rows score within the
    # tolerance of each other (exact f64 scores of the same bf16 inputs)
    c = tc.double().numpy()[:, :prefix]
    q = tq.double().numpy()[:, :prefix]
    inv = ti.double().numpy() if ti is not None else 1.0
    exact = (q @ c.T) * inv
    rows = np.nonzero(diff)[0]
    a = exact[rows, jids[diff]]
    b = exact[rows, tids[diff]]
    assert np.abs(a - b).max() <= 2 * atol
    assert diff.mean() < 0.01


PATHS = ["packed", "packed_scaled", "int8_general", "f32"]
# (strips, strip_outputs); int8_general blocks hold 262 row groups, so it
# takes 2 strips where the others take 4
STRIPS = [(1, False), (4, False), (4, True)]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("strips,strip_outputs", STRIPS)
@pytest.mark.parametrize("masked", [False, True])
def test_scan_sheet_matches_pallas(rng, path, strips, strip_outputs,
                                   masked):
    if path == "int8_general":
        # _packed_fits fails: (1024*127^2+1) * 131 row groups >= 2^31
        block, strips = 2 * 131 * 128, min(strips, 2)
        n = block + 300  # ragged tail: exercises padding + valid_n
    else:
        block = 1024
        n = block * 2 + 300
    corpus, queries, inv = _setup(rng, path, n)
    mask = rng.random(n) > 0.3 if masked else None
    prefix = 64 if path == "f32" else None
    jv, jids, tv, tids, tc, tq, ti = _run(
        corpus, queries, inv, mask, block_rows=block, strips=strips,
        strip_outputs=strip_outputs, prefix_dim=prefix)
    assert tf.fused_scan_topk.last_path == path
    bins = 128 * (strips if strip_outputs else 1)
    assert tv.shape == tids.shape == (5, -(-n // block) * bins)
    if path == "f32":
        _check_f32_sheet(jv, jids, tv, tids, tc, tq, ti, 128)
    else:
        np.testing.assert_array_equal(tids, jids)   # bit-equal
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))


# depths at the CUDA int8 kernel's edges, which the chip checks hold it to
# this plain version at: d = 100 ends inside a 16-byte unit (4-byte copies),
# d = 2048 is past its resident query tile (query chunks ride in the ring);
# 67 queries is no multiple of its 64- and 128-query tiles
@pytest.mark.parametrize("path", ["packed", "packed_scaled", "int8_general"])
@pytest.mark.parametrize("d", [100, 2048])
def test_scan_sheet_matches_pallas_depths(rng, path, d):
    if path == "int8_general":
        # the fewest row groups whose packed keys overflow int32 at this d
        rows = -(-2 ** 31 // (d * 127 * 127 + 1))
        block, strips, strip_outputs = rows * 128, 1, False
        n = block + 300
    else:
        block, strips, strip_outputs = 1024, 2, True
        n = 2 * block + 300
    corpus, queries, inv = _setup(rng, path, n, d=d, nq=67)
    mask = rng.random(n) > 0.3
    jv, jids, tv, tids, *_ = _run(corpus, queries, inv, mask,
                                  block_rows=block, strips=strips,
                                  strip_outputs=strip_outputs)
    assert tf.fused_scan_topk.last_path == path
    bins = 128 * (strips if strip_outputs else 1)
    assert tv.shape == (67, -(-n // block) * bins)
    np.testing.assert_array_equal(tids, jids)   # bit-equal
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))


# the f32 path at the CUDA bf16 kernel's edges, which the chip checks hold it
# to this plain version at, with bf16 corpus and bf16 queries as `fused_core`
# passes them: d = 72 ends inside a staged chunk, 256 and 768 are 2 and 6
# chunks a row group; 67 queries is no multiple of its 32-, 64- and 128-query
# tiles; prefix 64 zeroes the query tail of the 128 columns loaded
@pytest.mark.parametrize("d,prefix", [(72, None), (128, 64), (256, None),
                                      (768, None), (768, 64)])
@pytest.mark.parametrize("strips,strip_outputs", [(1, False), (2, True)])
def test_scan_sheet_f32_matches_pallas_depths(rng, d, prefix, strips,
                                              strip_outputs):
    block = 1024
    n = 2 * block + 300  # ragged tail: padding + valid_n inside a block
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    qs = x[:67] + 0.05 * rng.standard_normal((67, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    inv = (1.0 / np.linalg.norm(x[:, :prefix or d], axis=-1)
           ).astype(np.float32)
    mask = rng.random(n) > 0.3
    jv, jids, tv, tids, tc, tq, ti = _run(
        x, qs, inv, mask, block_rows=block, strips=strips,
        strip_outputs=strip_outputs, prefix_dim=prefix)
    assert tf.fused_scan_topk.last_path == "f32"
    assert tq.dtype == tc.dtype == torch.bfloat16
    bins = 128 * (strips if strip_outputs else 1)
    assert tv.shape == tids.shape == (67, -(-n // block) * bins)
    assert np.isfinite(tv).all()  # every bin holds a live row
    # F32_ATOL covers d = 128 (d * 2^-24 a side); scale it with the depth
    # the dot runs over
    depth = prefix or d
    _check_f32_sheet(jv, jids, tv, tids, tc, tq, ti, depth,
                     atol=F32_ATOL * max(1.0, depth / 128))


BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


# the kernel `scan_sheet` launches on a CUDA corpus, as a function of what it
# can see of its operands: (corpus dtype, query dtype, d, row stride in
# elements, corpus address, query address) -> the source under csrc/
@pytest.mark.parametrize("args,route", [
    ((I8, I8, 768, 768, 0, 0), "fused_scan_int8"),
    ((I8, I8, 100, 116, 4, 4), "fused_scan_int8"),
    ((BF16, BF16, 128, 768, 0, 0), "fused_scan_bf16"),   # the cascade scan
    ((BF16, BF16, 72, 72, 256, 512), "fused_scan_bf16"),
    ((BF16, BF16, 100, 116, 4, 4), "fused_scan_bf16"),   # 4-byte copies
    ((BF16, BF16, 101, 101, 0, 0), "fused_scan"),        # odd depth
    ((BF16, BF16, 100, 117, 0, 0), "fused_scan"),        # odd row stride
    ((BF16, BF16, 128, 768, 2, 0), "fused_scan"),        # corpus off 4 bytes
    ((BF16, BF16, 128, 768, 0, 6), "fused_scan"),        # queries off 4 bytes
    ((BF16, F32, 128, 768, 0, 0), "fused_scan"),         # f32 queries
    ((F32, F32, 128, 768, 0, 0), "fused_scan"),
    ((F32, BF16, 128, 768, 0, 0), "fused_scan"),
])
def test_scan_route(args, route):
    assert tf.scan_route(*args) == route
    assert route in tf.ROUTES and route in tf.route_launches


def test_scan_route_of_the_cascade_operands(rng):
    """`fused_scan_topk` hands the wrapper what `fused_core` scans with: a
    128-column slice of the bf16 plane and bf16 queries. On the CPU the
    wrapper counts no launch, so ask the route of those very tensors."""
    plane = torch.zeros((1024, 768), dtype=BF16)
    q = torch.zeros((8, 768), dtype=BF16)
    seen = {}

    def spy(corpus, queries, *a, **kw):
        queries = queries.contiguous()
        seen["route"] = tf.scan_route(corpus.dtype, queries.dtype,
                                      corpus.shape[1], corpus.stride(0),
                                      corpus.data_ptr(), queries.data_ptr())
        return tf.scan_sheet_plain(corpus, queries, *a, **kw)

    real, tf.scan_sheet = tf.scan_sheet, spy
    try:
        tf.fused_scan_topk(plane, q, 4, block_rows=512, prefix_dim=64,
                           inv_norms=torch.ones(1024))
    finally:
        tf.scan_sheet = real
    assert seen["route"] == "fused_scan_bf16"
    assert all(v == 0 for v in tf.route_launches.values())  # CPU: no launch


@pytest.mark.parametrize("path", ["packed", "f32"])
@pytest.mark.parametrize("prefix_dim", [None, 64])
@pytest.mark.parametrize("q_block", [None, 3])
def test_select_prefix_q_block(rng, path, prefix_dim, q_block):
    corpus, queries, inv = _setup(rng, path, 2500)
    if prefix_dim is None:
        inv = None if path == "f32" else inv
    mask = rng.random(2500) > 0.2
    jv, jids, tv, tids, *_ = _run(corpus, queries, inv, mask, k=20,
                                  select=True, block_rows=512,
                                  prefix_dim=prefix_dim, q_block=q_block)
    assert tv.shape == (5, 20) and tids.dtype == np.int32
    if path == "packed":
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=0, atol=F32_ATOL)
        assert (tids == jids).mean() >= 0.95


def test_empty_bins_are_neg_inf_after_select(rng):
    corpus, queries, _ = _setup(rng, "packed", 1024)
    mask = np.zeros(1024, dtype=bool)
    mask[:5] = True  # 5 live rows; 12 requested
    jv, jids, tv, tids, *_ = _run(corpus, queries, None, mask, k=12,
                                  select=True, block_rows=512)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tv, jv)
    assert np.isneginf(tv[:, 5:]).all() and np.isfinite(tv[:, :5]).all()


def test_query_chunking_matches_unchunked(rng, monkeypatch):
    corpus, queries, _ = _setup(rng, "packed", 4096)
    queries = np.concatenate([queries] * 60)  # 300 queries
    tc, tq = torch.from_numpy(corpus), torch.from_numpy(queries)
    base = tf.fused_scan_topk(tc, tq, 10, block_rows=1024, q_block=128)
    monkeypatch.setattr(tf, "_SHEET_BYTES_BUDGET", 8 * 4 * 128 * 128)
    tf.fused_scan_topk.last_chunk = None
    chunked = tf.fused_scan_topk(tc, tq, 10, block_rows=1024, q_block=128)
    assert tf.fused_scan_topk.last_chunk == 128
    np.testing.assert_array_equal(chunked[1].numpy(), base[1].numpy())
    np.testing.assert_array_equal(chunked[0].numpy(), base[0].numpy())
    jv, jids = jf.fused_scan_topk(jnp.asarray(corpus), jnp.asarray(queries),
                                  10, block_rows=1024, q_block=128)
    np.testing.assert_array_equal(chunked[1].numpy(), np.asarray(jids))


def test_scan_sheet_rejects_other_devices():
    c = torch.zeros((256, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tf.scan_sheet(c, c[:4], None, None, valid_n=None, block_rows=256,
                      mode="packed", strips=1, strip_outputs=False)
