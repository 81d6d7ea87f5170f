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
    """`DenseIndex.insert` calls the in-place kernel wrapper once per
    insert in every storage mode, on the index's own planes (capacity
    mode passes no int8 plane: it scales its int8 per row itself), and
    the planes hold what `prepare_vectors` gives."""
    calls = []

    def counting(x, dims, vecs, int8, inv_norms, live, start):
        calls.append((tuple(x.shape), tuple(dims), vecs is idx.vecs,
                      int8 is None, inv_norms is idx.inv_norms,
                      live is idx.live, start))
        return tq.prepare_vectors_into(x, dims, vecs, int8, inv_norms, live,
                                       start)

    monkeypatch.setattr(tdense, "prepare_vectors_into", counting)
    idx = tdense.DenseIndex(IndexConfig(dim=64, matryoshka_dims=(16, 32),
                                        initial_capacity=16, **mode),
                            device="cpu")
    x = _inputs(40, 64, seed=9)
    idx.insert(x[:10])
    idx.insert(x[10:])  # grows 16 -> 64
    scaled = idx.int8_recip is not None
    assert calls == [((10, 64), (16, 32), True, scaled or idx.int8 is None,
                      True, True, 0),
                     ((30, 64), (16, 32), True, scaled or idx.int8 is None,
                      True, True, 10)]
    norm, i8, inv = tq.prepare_vectors(torch.from_numpy(x), (16, 32))
    assert torch.equal(idx.inv_norms[:40], inv)
    assert bool(idx.live[:40].all()) and not bool(idx.live[40:].any())
    if idx.vecs is not None:
        assert torch.equal(idx.vecs[:40], norm)
    if idx.int8 is not None and not scaled:
        assert torch.equal(idx.int8[:40], i8)


def _planes(cap, d, m, seed):
    """Index planes filled with random bits, so a write outside its rows
    shows."""
    g = torch.Generator().manual_seed(seed)
    return dict(
        vecs=torch.randint(-2**15, 2**15, (cap, d), generator=g,
                           dtype=torch.int16).view(torch.bfloat16),
        int8=torch.randint(-128, 128, (cap, d), generator=g,
                           dtype=torch.int8),
        inv_norms=torch.randn((cap, m), generator=g),
        live=torch.rand((cap,), generator=g) > 0.5)


@pytest.mark.parametrize("case", ["start 0", "middle offset", "after a grow"])
def test_prepare_vectors_into_plain_writes_only_its_rows(case):
    """The in-place pass equals `prepare_vectors_plain` followed by the
    slice copies, and leaves every other row bit for bit as it was."""
    d, dims = 100, (16, 64, 100)
    cap, n, start = {"start 0": (64, 40, 0), "middle offset": (64, 21, 23),
                     "after a grow": (256, 90, 64)}[case]
    planes = _planes(cap, d, len(dims), seed=cap + start)
    if case == "after a grow":  # DenseIndex._grow: zeros past the old rows
        for t in planes.values():
            t[64:] = 0
    before = {k: v.clone() for k, v in planes.items()}
    x = torch.from_numpy(_inputs(n, d, seed=start))
    tq.prepare_vectors_into(x, dims, planes["vecs"], planes["int8"],
                            planes["inv_norms"], planes["live"], start)
    norm, i8, inv = tq.prepare_vectors_plain(x, dims)
    end = start + n
    want = dict(vecs=norm, int8=i8, inv_norms=inv,
                live=torch.ones(n, dtype=torch.bool))
    for name, t in planes.items():
        bits = (lambda a: a.view(torch.int16)) if name == "vecs" else \
            (lambda a: a)
        assert torch.equal(bits(t[start:end]), bits(want[name])), name
        assert torch.equal(bits(t[:start]), bits(before[name][:start])), name
        assert torch.equal(bits(t[end:]), bits(before[name][end:])), name


def test_prepare_vectors_into_skips_absent_planes():
    """A plane given as None is not written; a device that is neither
    the CPU nor CUDA raises (no fallback)."""
    planes = _planes(32, 64, 2, seed=1)
    x = torch.from_numpy(_inputs(8, 64, seed=2))
    tq.prepare_vectors_into(x, (16, 64), None, None, planes["inv_norms"],
                            planes["live"], 4)
    assert bool(planes["live"][4:12].all())
    with pytest.raises(ValueError, match="unsupported device"):
        tq.prepare_vectors_into(x.to("meta"), (16, 64), None, None,
                                planes["inv_norms"], planes["live"], 28)


def _kernel_order_model(x, dims):
    """The prep kernel's arithmetic, one f32 operation at a time in its
    order: lane l adds elements 4 (l + 32 k) + 0..3 for k = 0, 1, ...;
    the 32 lane sums add by halves (the shuffle butterfly); 1 / sqrt in
    f64 rounded once to f32."""
    f = np.float32

    def lane_sum(sq):
        d = sq.shape[0]
        lanes = [f(0.0)] * 32
        for c in range(d):
            lane = (c // 4) % 32
            lanes[lane] = f(lanes[lane] + sq[c])
        w = 32
        while w > 1:
            w //= 2
            lanes = [f(lanes[i] + lanes[i + w]) for i in range(w)]
        return lanes[0]

    def inv_norm(s):
        return f(1.0 / np.sqrt(np.float64(max(s, f(1e-12)))))

    rows = []
    for r in x:
        xn = (r * inv_norm(lane_sum(r * r))).astype(np.float32)
        rows.append((xn, [inv_norm(lane_sum((xn * xn)[:dj])) for dj in dims]))
    return rows


@pytest.mark.parametrize("d", [100, 768, 1100])
def test_plain_adds_in_the_kernel_order(d):
    """The plain version is the kernel's arithmetic: its normalized rows
    and inverse norms equal a scalar model of the kernel's order bit for
    bit (d 768 is the index's width, 1100 takes the kernel's second
    read)."""
    x = _inputs(6, d, seed=d)
    dims = (64, 96, d)
    norm, i8, inv = tq.prepare_vectors_plain(torch.from_numpy(x), dims)
    for r, (xn, invs) in enumerate(_kernel_order_model(x, dims)):
        want = torch.from_numpy(xn)
        assert torch.equal(norm[r].view(torch.int16),
                           want.to(torch.bfloat16).view(torch.int16))
        assert torch.equal(i8[r], tq.quantize_int8(want))
        np.testing.assert_array_equal(inv[r].numpy(),
                                      np.array(invs, dtype=np.float32))


@pytest.mark.parametrize("mode", [dict(), dict(store_bf16=False)])
def test_dense_index_matches_reference_at_default_widths(mode):
    """A JAX DenseIndex and the port's, fed the same inserts at the
    default width and matryoshka dims (768; 64, 128, 256) across a grow,
    hold the same tables: bf16 and int8 within the bounds of XLA's rsqrt
    (ROADMAP §3), inverse norms to f32 rounding, live equal."""
    from rag_application_tpu.config import IndexConfig as JIndexConfig
    from rag_application_tpu.index.dense import DenseIndex as JDenseIndex

    kw = dict(initial_capacity=64, **mode)
    j = JDenseIndex(JIndexConfig(**kw))
    t = tdense.DenseIndex(IndexConfig(**kw), device="cpu")
    assert t.cfg.dim == 768 and t.cfg.matryoshka_dims == (64, 128, 256)
    for n, seed in ((64, 1), (1, 2), (70, 3)):  # the third grows 128 -> 256
        x = _inputs(n, 768, seed=seed)
        np.testing.assert_array_equal(j.insert(x), t.insert(x))
    assert t.size == j.size == 135 and t.capacity == j.capacity == 256
    np.testing.assert_array_equal(t.live.numpy(), np.asarray(j.live))
    np.testing.assert_allclose(t.inv_norms.numpy(), np.asarray(j.inv_norms),
                               rtol=1e-6)
    if j.vecs is not None:
        tb = _bits(t.vecs.view(torch.int16).numpy())
        jb = _bits(np.asarray(j.vecs))
        assert np.abs(tb - jb).max() <= 1 and (tb != jb).mean() < 1e-2
    d8 = np.abs(t.int8.numpy().astype(np.int32)
                - np.asarray(j.int8).astype(np.int32))
    assert d8.max() <= 1 and d8.mean() < 1e-3
    if j.int8_recip is not None:
        np.testing.assert_allclose(t.int8_recip.numpy(),
                                   np.asarray(j.int8_recip), rtol=1e-6)
