"""Parity of the port's top-k, blocked search, rescore and RRF ops with
the JAX reference, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.ops import rrf as jr
from rag_application_tpu.ops import topk as jt
from rag_application_tpu_torch.ops import rrf as tr
from rag_application_tpu_torch.ops import topk as tt
from rag_application_tpu_torch.state import bf16_from_bits


def test_stable_topk_tie_order():
    """jax.lax.top_k breaks ties toward the lower index; torch.topk does
    not. The port's helper must give JAX's order."""
    x = np.tile(np.array([1, 3, 3, 2, 3, 0], dtype=np.float32), 50)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = tt.stable_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(np.asarray(ji), [1, 2, 4, 7])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # approx_max_k is exact on the CPU backend and keeps the same order
    _, ja = jax.lax.approx_max_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(np.asarray(ja), ti.numpy())


def test_stable_topk_integer_ties_batched(rng):
    x = rng.integers(-5, 5, (16, 300)).astype(np.float32)
    x[:, ::7] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(x), 40)
    tv, ti = tt.stable_topk(torch.from_numpy(x), 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_merge_topk(rng):
    va = rng.integers(0, 6, (5, 8)).astype(np.float32)
    vb = rng.integers(0, 6, (5, 12)).astype(np.float32)
    ia = rng.integers(0, 100, (5, 8)).astype(np.int32)
    ib = rng.integers(0, 100, (5, 12)).astype(np.int32)
    j = jt.merge_topk(*(jnp.asarray(a) for a in (va, ia, vb, ib)), 7)
    t = tt.merge_topk(*(torch.from_numpy(a) for a in (va, ia, vb, ib)), 7)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))


def _normed(rng, n, d):
    x = (rng.standard_normal((n, d))
         * np.exp(-0.02 * np.arange(d))).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("extras", ["plain", "valid_n+mask", "prefix+inv"])
def test_blocked_topk(rng, dtype, extras):
    n, d, q, k, block = 700, 64, 6, 9, 256
    x = _normed(rng, n, d)
    qs = x[:q] + 0.05 * rng.standard_normal((q, d)).astype(np.float32)
    if dtype == "int8":
        c = np.clip(np.round(x * 127), -127, 127).astype(np.int8)
        qq = np.clip(np.round(qs * 127), -127, 127).astype(np.int8)
        jc, jq_, tc, tq_ = (jnp.asarray(c), jnp.asarray(qq),
                            torch.from_numpy(c), torch.from_numpy(qq))
    elif dtype == "bf16":
        jc = jnp.asarray(x, jnp.bfloat16)
        jq_ = jnp.asarray(qs, jnp.bfloat16)
        tc = bf16_from_bits(np.asarray(jc).view(np.uint16), "cpu")
        tq_ = bf16_from_bits(np.asarray(jq_).view(np.uint16), "cpu")
    else:
        jc, jq_, tc, tq_ = (jnp.asarray(x), jnp.asarray(qs),
                            torch.from_numpy(x), torch.from_numpy(qs))
    kw_j, kw_t = {}, {}
    if extras == "valid_n+mask":
        mask = rng.random(n) > 0.3
        kw_j = dict(valid_n=650, filter_mask=jnp.asarray(mask))
        kw_t = dict(valid_n=650, filter_mask=torch.from_numpy(mask))
    elif extras == "prefix+inv":
        inv = (1.0 / np.linalg.norm(x[:, :32], axis=-1)).astype(np.float32)
        kw_j = dict(prefix_dim=32, inv_norms=jnp.asarray(inv))
        kw_t = dict(prefix_dim=32, inv_norms=torch.from_numpy(inv))
    jv, ji = jt.blocked_topk(jc, jq_, k, block_size=block, **kw_j)
    tv, ti = tt.blocked_topk(tc, tq_, k, block_size=block, **kw_t)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # int8 sums are exact; float sums differ in order only (f32 rounding)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5 if dtype != "int8" else 0)


def test_gather_rescore(rng):
    x = _normed(rng, 200, 48)
    qs = rng.standard_normal((4, 48)).astype(np.float32)
    cand = rng.integers(0, 200, (4, 17)).astype(np.int32)
    valid = rng.random((4, 17)) > 0.2
    j = np.asarray(jt.gather_rescore(jnp.asarray(x), jnp.asarray(qs),
                                     jnp.asarray(cand),
                                     candidate_valid=jnp.asarray(valid)))
    t = tt.gather_rescore(torch.from_numpy(x), torch.from_numpy(qs),
                          torch.from_numpy(cand),
                          candidate_valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_allclose(t[valid], j[valid], rtol=1e-5, atol=1e-6)


def test_first_occurrence_mask(rng):
    ids = rng.integers(0, 20, (6, 40)).astype(np.int32)
    j = np.asarray(jr.first_occurrence_mask(jnp.asarray(ids)))
    t = tr.first_occurrence_mask(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("k", [5, 40])
def test_rrf_fuse(rng, k):
    lists_np = []
    for width in (10, 8):
        ids = rng.integers(0, 25, (4, width)).astype(np.int32)
        valid = rng.random((4, width)) > 0.2
        lists_np.append((ids, valid))
    j = jr.rrf_fuse([(jnp.asarray(i), jnp.asarray(v)) for i, v in lists_np],
                    k, rrf_k=60)
    t = tr.rrf_fuse([(torch.from_numpy(i), torch.from_numpy(v))
                     for i, v in lists_np], k, rrf_k=60)
    assert tuple(t[1].shape) == (4, k)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-6)
    assert tr.INVALID_ID == int(jr.INVALID_ID) == 2147483647
