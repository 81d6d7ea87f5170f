"""The port's `TextEncoder` against the flax reference on the same weights,
on the CPU.

The flax params are carried over with `state.encoder_params_from_jax`;
the port's RNG never has to match `jax.random`. Tolerances:
  * float32 config: pooled unit vectors within atol 1e-5 and token
    outputs within 1e-5 of max|token| (the same f32 products summed in
    another order);
  * bf16 config (the default dtype): cosine >= 0.999 per pooled row and
    token outputs within 2% of max|token|; XLA CPU and torch round bf16
    at other points (the softmax's exp and sum, gelu, the residual adds).
A row with no valid token (the padded tail of `Embedder.encode`) attends
uniformly in both, stays finite and pools to the zero vector.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.models.tokenizer import HashTokenizer as JTokenizer
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import EncoderConfig
from rag_application_tpu_torch.models import encoder as tenc
from rag_application_tpu_torch.models.tokenizer import HashTokenizer
from rag_application_tpu_torch.search.fused import FusedSearcher

SMALL = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=4,
             mlp_dim=64, max_len=32, out_dim=16)
TEXTS = ["Hello, world!", "a longer sentence with some more words " * 3,
         "x", "Tokens: 123 and ÜNICODE ß.", ""]


@functools.lru_cache(maxsize=None)
def carried(dtype, seed=3):
    """(JAX EncoderState, port EncoderState) holding the same weights."""
    kw = dict(SMALL, dtype=dtype)
    js = j_init(JEncoderConfig(**kw), max_len=32, seed=seed)
    cfg = EncoderConfig(**kw)
    ts = tenc.init_encoder(cfg, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return js, ts


def batch():
    ids, mask = JTokenizer(512, 32).encode_batch(TEXTS, 32)
    ids[0, mask[0].sum():] = 77   # garbage in the padding
    mask[-1] = False              # a row with no valid token
    return ids, mask


def test_tokenizer_ids_equal_reference():
    for max_len in (8, 32):
        j = JTokenizer(512, 32).encode_batch(TEXTS, max_len)
        t = HashTokenizer(512, 32).encode_batch(TEXTS, max_len)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(dtype):
    js, ts = carried(dtype)
    ids, mask = batch()
    fwd = jax.jit(lambda p, i, m: js.model.apply(p, i, m,
                                                  return_tokens=True))
    jp, jt = (np.asarray(a) for a in fwd(js.params, jnp.asarray(ids),
                                          jnp.asarray(mask)))
    tp, tt = ts.model.apply(ts.params, torch.from_numpy(ids),
                            torch.from_numpy(mask), return_tokens=True)
    tp, tt = tp.numpy(), tt.numpy()
    assert tp.shape == (len(TEXTS), 16) and tt.shape == (len(TEXTS), 32, 16)
    assert tp.dtype == tt.dtype == np.float32
    real = mask.any(axis=1)
    tok_tol = (1e-5 if dtype == "float32" else 2e-2) * np.abs(jt).max()
    assert np.abs(tt - jt)[mask].max() <= tok_tol
    if dtype == "float32":
        np.testing.assert_allclose(tp, jp, atol=1e-5)
    else:
        cos = (tp[real] * jp[real]).sum(-1)
        assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(tp[real], axis=-1), 1.0,
                               atol=1e-5)
    # pooled-only call gives the same vectors
    np.testing.assert_array_equal(
        ts.model.apply(ts.params, torch.from_numpy(ids),
                       torch.from_numpy(mask)).numpy(), tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_rows_finite_zero_and_inert(dtype):
    """Rows with no valid token are finite, pool to zero, and do not
    change the other rows; garbage ids under the mask change nothing."""
    _, ts = carried(dtype)
    ids, mask = batch()
    real = mask.any(axis=1)
    run = lambda i, m: ts.model.apply(  # noqa: E731
        ts.params, torch.from_numpy(i), torch.from_numpy(m),
        return_tokens=True)
    pooled, tokens = run(ids, mask)
    assert torch.isfinite(tokens).all() and torch.isfinite(pooled).all()
    assert not pooled[~torch.from_numpy(real)].any()
    # pad the batch with three all-False rows, as Embedder.encode does
    pad_ids = np.pad(ids, ((0, 3), (0, 0)))
    pad_mask = np.pad(mask, ((0, 3), (0, 0)))
    p2, _ = run(pad_ids, pad_mask)
    assert not p2[len(TEXTS):].any()
    np.testing.assert_allclose(p2[:len(TEXTS)].numpy(), pooled.numpy(),
                               atol=1e-6)
    ids2 = ids.copy()
    ids2[~mask] = 5
    np.testing.assert_allclose(run(ids2, mask)[0].numpy(), pooled.numpy(),
                               atol=1e-6)


def test_apply_takes_own_params_only_and_multimodal_raises():
    _, ts = carried("float32")
    _, other = carried("float32", seed=4)
    ids, mask = (torch.from_numpy(a) for a in batch())
    own = ts.model.apply(ts.params, ids, mask)
    assert torch.equal(ts.model.apply(None, ids, mask), own)
    assert not own.requires_grad
    assert not torch.equal(other.model.apply(other.params, ids, mask), own)
    assert ts.model.owns(ts.params) and ts.model.owns(None)
    assert not ts.model.owns(other.params)
    # the tokens wire checks the params once, when the encoder is bound
    searcher = FusedSearcher(None)
    searcher.bind_encoder(ts.model, ts.params)
    with pytest.raises(ValueError, match="load_state_dict"):
        searcher.bind_encoder(ts.model, other.params)
    with pytest.raises(NotImplementedError):
        tenc.init_encoder(EncoderConfig(**SMALL), multimodal=True,
                          device="cpu")
    with pytest.raises(NotImplementedError):
        tenc.MultimodalEncoder(EncoderConfig(**SMALL))


def test_init_encoder_seeded_and_defaults():
    cfg = EncoderConfig(**SMALL)
    a = tenc.init_encoder(cfg, seed=7, device="cpu")
    b = tenc.init_encoder(cfg, seed=7, device="cpu")
    for n, t in a.params.items():
        assert torch.equal(t, b.params[n]), n
    assert a.params["layers.0.ln1_scale"].eq(1).all()
    assert not a.params["layers.0.qkv_b"].any()
    # flax's scales: embeddings and kernels N(0, 1/fan_in)
    std = a.params["layers.0.mlp1_w"].std().item()
    assert abs(std - 32 ** -0.5) < 0.03
    d = EncoderConfig()
    assert (d.vocab_size, d.hidden_dim, d.num_layers, d.num_heads,
            d.mlp_dim, d.max_len, d.out_dim, d.dtype) == \
        (30528, 384, 6, 12, 1536, 512, 768, "bfloat16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tenc.init_encoder(cfg)
