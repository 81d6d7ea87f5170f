"""The insert-time prep pass: the port's `prepare_vectors` against the JAX
reference's, on the CPU.

On a CPU tensor the wrapper runs its plain version; the JAX side runs its
Pallas `_prep_kernel` in interpret mode (as tests/test_quant.py does) and
its XLA twin `prepare_vectors_xla`. XLA CPU's rsqrt is up to 2 ulp from
torch's and its row sums add in another order (ROADMAP §3), so a derived
element can sit one rounding step apart: the bf16 plane within 1 bf16 ulp
(under 1% of elements), int8 within one step (under 0.1%), inv_norms to
rtol 1e-6. A zero row is exact: zeros and inverse norms of 1e6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.ops import quant as jq
from rag_application_tpu_torch.config import IndexConfig
from rag_application_tpu_torch.index import dense as tdense
from rag_application_tpu_torch.ops import quant as tq

# (n, d, dims): every n in (1, 48, 1037), d in (32, 100, 128) and dims in
# ((), (16,), (16, 32, d)); d = 100 is no multiple of 4
CASES = [
    (1, 32, ()),
    (1, 128, (16, 32, 128)),
    (48, 128, (16, 32, 128)),
    (48, 100, (16,)),
    (1037, 100, (16, 32, 100)),
    (1037, 32, ()),
    (1037, 128, (16,)),
]


def _bits(a):
    return np.asarray(a).view(np.uint16).astype(np.int32)


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 3.0).astype(np.float32)
    if n > 1:
        x[0] = 0.0           # a zero row
        x[-1] *= 1e-3        # rows far from unit norm
        x[n // 2] *= 1e3
    return x


def _assert_close(t_out, j_out):
    tn, t8, ti = t_out
    jn, j8, ji = (np.asarray(a) for a in j_out)
    assert tn.dtype == torch.bfloat16 and t8.dtype == torch.int8
    assert ti.dtype == torch.float32 and ti.shape == ji.shape
    tb = _bits(tn.view(torch.int16).numpy())
    jb = _bits(jn)
    assert np.abs(tb - jb).max() <= 1
    assert (tb != jb).mean() < 1e-2
    d8 = np.abs(t8.numpy().astype(np.int32) - j8.astype(np.int32))
    assert d8.max() <= 1 and d8.mean() < 1e-3
    np.testing.assert_allclose(ti.numpy(), ji, rtol=1e-6)


@pytest.mark.parametrize("n,d,dims", CASES)
def test_prepare_vectors_matches_reference(n, d, dims):
    x = _inputs(n, d, seed=n * 1000 + d)
    out = tq.prepare_vectors(torch.from_numpy(x), dims)
    assert [tuple(o.shape) for o in out] == [(n, d), (n, d), (n, len(dims))]
    # the Pallas kernel (interpret mode) with a row block that does not
    # divide n, and the XLA twin. The reference's kernel refuses dims=()
    # (its inv_norms block is zero columns wide: a division by zero in
    # the block grid), so those cases hold against the XLA twin alone.
    if dims:
        _assert_close(out, jq.prepare_vectors(jnp.asarray(x), dims,
                                              block_rows=512))
    _assert_close(out, jq.prepare_vectors_xla(jnp.asarray(x), dims))
    if n > 1:  # the zero row
        assert not out[0][0].float().any() and not out[1][0].any()
        np.testing.assert_array_equal(out[2][0].numpy(), 1e6)


def test_reference_kernel_refuses_empty_dims():
    """Pins the reference quirk the port does not share (ROADMAP §3)."""
    x = jnp.ones((8, 32), dtype=jnp.float32)
    with pytest.raises(ZeroDivisionError):
        jq.prepare_vectors(x, ())
    assert tq.prepare_vectors(torch.ones((8, 32)), ())[2].shape == (8, 0)


def test_plain_is_the_xla_twin_and_counts_no_launch():
    x = torch.from_numpy(_inputs(48, 64, seed=5))
    before = tq.prepare_vectors.launches
    for a, b in zip(tq.prepare_vectors(x, (16, 64)),
                    tq.prepare_vectors_plain(x, (16, 64))):
        assert torch.equal(a, b)
    assert tq.prepare_vectors_plain is tq.prepare_vectors_xla
    assert tq.prepare_vectors.launches == before  # CPU: no kernel launch


def test_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        tq.prepare_vectors(torch.empty((4, 8), device="meta"), (4,))


@pytest.mark.parametrize("mode", [dict(), dict(store_bf16=False),
                                  dict(store_int8=False)])
def test_dense_insert_goes_through_prepare_vectors(monkeypatch, mode):
    """`DenseIndex.insert` calls the kernel wrapper once per insert in
    every storage mode, and stores what it returns (capacity mode keeps
    only the inverse norms)."""
    calls = []

    def counting(x, dims, **kw):
        calls.append((tuple(x.shape), tuple(dims)))
        return tq.prepare_vectors(x, dims, **kw)

    monkeypatch.setattr(tdense, "prepare_vectors", counting)
    idx = tdense.DenseIndex(IndexConfig(dim=64, matryoshka_dims=(16, 32),
                                        initial_capacity=16, **mode),
                            device="cpu")
    x = _inputs(40, 64, seed=9)
    idx.insert(x[:10])
    idx.insert(x[10:])  # grows 16 -> 64
    assert calls == [((10, 64), (16, 32)), ((30, 64), (16, 32))]
    norm, i8, inv = tq.prepare_vectors(torch.from_numpy(x), (16, 32))
    assert torch.equal(idx.inv_norms[:40], inv)
    if idx.vecs is not None:
        assert torch.equal(idx.vecs[:40], norm)
    if idx.int8 is not None and idx.int8_recip is None:
        assert torch.equal(idx.int8[:40], i8)
