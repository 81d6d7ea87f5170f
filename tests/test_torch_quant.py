"""Parity of the port's quantization ops with the JAX reference.

Same numpy inputs through `rag_application_tpu.ops.quant` and
`rag_application_tpu_torch.ops.quant`, on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.ops import quant as jq
from rag_application_tpu_torch.ops import quant as tq


def _bf16_bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("d", [32, 96, 768])
def test_quantize_int8_bits_equal(rng, d):
    # values on and around the .5 rounding boundaries of x*127 (half to
    # even in both), plus out-of-range values that clip
    base = rng.standard_normal((64, d)).astype(np.float32) * 0.2
    halves = (np.arange(-300, 300, dtype=np.float32) + 0.5) / 127.0
    x = np.concatenate([base.ravel(), halves, [1.5, -1.5]])
    x = x[: (x.size // d) * d].reshape(-1, d)
    j = np.asarray(jq.quantize_int8(jnp.asarray(x)))
    t = tq.quantize_int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(j, t)  # tolerance: bit-equal
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize_int8(jnp.asarray(j))),
        tq.dequantize_int8(torch.from_numpy(t)).numpy())


def test_bf16_cast_bits_equal(rng):
    x = rng.standard_normal((256, 64)).astype(np.float32)
    j = _bf16_bits(jnp.asarray(x).astype(jnp.bfloat16))
    t = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(j, t.view(np.uint16))  # bit-equal


def test_matryoshka_inv_norms(rng):
    x = rng.standard_normal((300, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    dims = (64, 128, 256)
    j = np.asarray(jq.matryoshka_inv_norms(jnp.asarray(x), dims))
    t = tq.matryoshka_inv_norms(torch.from_numpy(x), dims).numpy()
    assert t.shape == (300, 3)
    # XLA CPU's rsqrt is not correctly rounded (up to 2 ulp) and sums in
    # another order: agree to a few f32 ulp
    np.testing.assert_allclose(t, j, rtol=1e-6)
    assert tq.matryoshka_inv_norms(torch.from_numpy(x), ()).shape == (300, 0)


@pytest.mark.parametrize("d", [64, 768])
def test_prepare_vectors_xla(rng, d):
    x = (rng.standard_normal((512, d))
         * np.exp(-0.01 * np.arange(d))).astype(np.float32)
    dims = (32, 64)
    jn, j8, ji = (np.asarray(a) for a in
                  jq.prepare_vectors_xla(jnp.asarray(x), dims))
    tn, t8, ti = tq.prepare_vectors_xla(torch.from_numpy(x), dims)
    # The normalized rows differ from the reference by <= 2 f32 ulp (the
    # row norm's rsqrt and sum order, see test_matryoshka_inv_norms), so
    # a derived element can land on the other side of a rounding edge:
    # bf16 within one bf16 ulp, int8 within one step, and almost all
    # elements identical.
    jb = _bf16_bits(jn).astype(np.int32)
    tb = tn.view(torch.int16).numpy().view(np.uint16).astype(np.int32)
    assert np.abs(jb - tb).max() <= 1
    assert (jb != tb).mean() < 1e-2
    diff8 = np.abs(j8.astype(np.int32) - t8.numpy().astype(np.int32))
    assert diff8.max() <= 1 and diff8.mean() < 1e-3
    np.testing.assert_allclose(ti.numpy(), ji, rtol=1e-6)
