"""The port's `MultimodalEncoder` and `Embedder.encode_image/encode_audio`
against the flax reference on the same weights, on the CPU.

The flax params of `init_encoder(multimodal=True)` are carried over with
`state.encoder_params_from_jax`; inputs are made from a seed with numpy
at the tower's real input sizes (224 x 224 x 3 images, 256 x 128 log-mel
clips) and the reference tests' TINY_MM widths. Tolerances:
  * float32 config: pooled unit vectors within atol 1e-5 and token
    outputs within 1e-5 of max|token| (the conv's 768-long and 256-long
    patch dots, like every product, summed in another order);
  * bf16 config: cosine >= 0.999 per pooled row and token outputs within
    2% of max|token|, as tests/test_torch_encoder.py states for the text
    tower: XLA CPU and torch round bf16 at other points (the conv's
    output before its bias moves by an ulp where the sums differ, the
    softmax, gelu, the residual adds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.models.tokenizer import HashTokenizer as JTokenizer
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import EncoderConfig
from rag_application_tpu_torch.models import MultimodalEncoder
from rag_application_tpu_torch.models import encoder as tenc
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.tokenizer import HashTokenizer

TINY_MM = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
               mlp_dim=64, max_len=32, out_dim=32)
TEXTS = ["a photo of a harbour at dusk", "", "x",
         "Tokens: 123 and ÜNICODE ß."]
B = len(TEXTS)


@functools.lru_cache(maxsize=None)
def carried(dtype, seed=5):
    """(JAX EncoderState, port EncoderState): the multimodal tower with the
    same weights."""
    kw = dict(TINY_MM, dtype=dtype)
    js = j_init(JEncoderConfig(**kw), max_len=32, seed=seed, multimodal=True)
    cfg = EncoderConfig(**kw)
    ts = tenc.init_encoder(cfg, multimodal=True, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return js, ts


def media(n, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((n, 224, 224, 3), dtype=np.float32)
    audio = rng.standard_normal((n, 256, 128)).astype(np.float32)
    return images, audio


def text_batch(empty=False):
    ids, mask = JTokenizer(512, 32).encode_batch(TEXTS, 32)
    ids[0, mask[0].sum():] = 77   # garbage in the padding
    if empty:
        mask[:] = False
    return ids, mask


def both(dtype, ids, mask, images=None, image_mask=None, audio=None,
         audio_mask=None):
    """(reference, port) outputs (pooled, tokens) as numpy."""
    js, ts = carried(dtype)
    fwd = jax.jit(lambda p, *a: js.model.apply(p, *a, return_tokens=True))
    args = (ids, mask, images, image_mask, audio, audio_mask)
    want = fwd(js.params, *(None if a is None else jnp.asarray(a)
                            for a in args))
    got = ts.model.apply(ts.params, *(None if a is None else
                                      torch.from_numpy(a) for a in args),
                         return_tokens=True)
    return ([np.asarray(a) for a in want], [t.numpy() for t in got])


def assert_close(dtype, want, got, valid):
    (jp, jt), (tp, tt) = want, got
    assert tp.dtype == tt.dtype == np.float32
    assert tp.shape == jp.shape and tt.shape == jt.shape
    assert np.isfinite(tt).all() and np.isfinite(tp).all()
    tok_tol = (1e-5 if dtype == "float32" else 2e-2) * np.abs(jt).max()
    assert np.abs(tt - jt)[valid].max() <= tok_tol
    real = valid.any(axis=1)
    if dtype == "float32":
        np.testing.assert_allclose(tp, jp, atol=1e-5)
    else:
        cos = (tp[real] * jp[real]).sum(-1)
        assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(tp[real], axis=-1), 1.0,
                               atol=1e-5)
    assert not tp[~real].any()


MODES = {
    "image": dict(images=True, text=False),
    "audio": dict(audio=True, text=False),
    "image+text": dict(images=True, text=True),
    "audio+text": dict(audio=True, text=True),
    "image+audio+text": dict(images=True, audio=True, text=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_flax(mode, dtype):
    m = MODES[mode]
    ids, mask = text_batch(empty=not m["text"])
    images, audio = media(B)
    images = images if m.get("images") else None
    audio = audio if m.get("audio") else None
    want, got = both(dtype, ids, mask, images=images, audio=audio)
    # the sequence is audio, then image, then text tokens
    n_audio = 128 if audio is not None else 0
    n_image = 196 if images is not None else 0
    assert got[1].shape == (B, n_audio + n_image + 32, 32)
    valid = np.concatenate([np.ones((B, n_audio + n_image), bool), mask], 1)
    assert_close(dtype, want, got, valid)
    # the pooled-only call gives the same vectors
    _, ts = carried(dtype)
    pooled = ts.model.apply(
        None, torch.from_numpy(ids), torch.from_numpy(mask),
        None if images is None else torch.from_numpy(images), None,
        None if audio is None else torch.from_numpy(audio))
    np.testing.assert_array_equal(pooled.numpy(), got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_media_masks(dtype):
    """An all-false image mask with an empty text mask leaves rows with no
    valid token (finite, pooled to zero); mixed media masks drop exactly
    their rows' patches, as the reference does."""
    images, audio = media(B, seed=1)
    ids, mask = text_batch(empty=True)
    off = np.zeros(B, bool)
    want, got = both(dtype, ids, mask, images=images, image_mask=off)
    assert not got[0].any() and not want[0].any()
    assert np.isfinite(got[1]).all()
    ids, mask = text_batch()
    image_mask = np.array([True, False, True, False])
    audio_mask = np.array([False, False, True, True])
    want, got = both(dtype, ids, mask, images=images, image_mask=image_mask,
                     audio=audio, audio_mask=audio_mask)
    valid = np.concatenate([np.repeat(audio_mask[:, None], 128, 1),
                            np.repeat(image_mask[:, None], 196, 1), mask], 1)
    assert_close(dtype, want, got, valid)
    # a row whose media mask is off pools like the text tower's row
    _, ts = carried(dtype)
    text_only = ts.model.apply(None, torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[0][1], text_only[1], atol=1e-6)


@functools.lru_cache(maxsize=None)
def embedders(batch_size=2):
    """(JAX Embedder, port Embedder) on the f32 multimodal tower."""
    js, ts = carried("float32")
    return (JEmbedder(js, batch_size=batch_size, max_len=32),
            Embedder(ts, batch_size=batch_size, max_len=32))


@pytest.mark.parametrize("captions", [False, True])
@pytest.mark.parametrize("kind", ["image", "audio"])
def test_embedder_encode_media(kind, captions):
    """n = batch_size + 1: one full batch and a padded tail of one."""
    je, te = embedders()
    n = te.batch_size + 1
    images, audio = media(n, seed=2)
    x = images if kind == "image" else audio
    texts = TEXTS[:n] if captions else None
    fn = "encode_image" if kind == "image" else "encode_audio"
    want = getattr(je, fn)(x, texts=texts)
    got = getattr(te, fn)(x, texts=texts)
    assert got.shape == (n, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # one item alone (a 2-D / 3-D input, padded to the batch) is the same
    one = getattr(te, fn)(x[-1], texts=None if texts is None else texts[-1:])
    np.testing.assert_allclose(one[0], got[-1], atol=1e-6)


BAD = {
    "image-shape": ("encode_image", lambda: np.zeros((2, 64, 64, 3)), None,
                    "images must be"),
    "image-captions": ("encode_image", lambda: np.zeros((2, 224, 224, 3)),
                       ["one"], "texts must match"),
    "audio-shape": ("encode_audio", lambda: np.zeros((2, 100, 128)), None,
                    "audio features must be"),
    "audio-captions": ("encode_audio", lambda: np.zeros((256, 128)),
                       ["a", "b"], "texts must match"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_embedder_value_errors(case):
    fn, x, texts, _ = BAD[case]
    je, te = embedders()
    with pytest.raises(ValueError) as jerr:
        getattr(je, fn)(x(), texts=texts)
    with pytest.raises(ValueError) as terr:
        getattr(te, fn)(x(), texts=texts)
    assert str(terr.value) == str(jerr.value)
    assert BAD[case][3] in str(terr.value)


@pytest.mark.parametrize("fn", ["encode_image", "encode_audio"])
def test_text_tower_refuses_media(fn):
    cfg = EncoderConfig(**TINY_MM, dtype="float32")
    te = Embedder(tenc.init_encoder(cfg, device="cpu"), batch_size=2,
                  max_len=32)
    je = JEmbedder(j_init(JEncoderConfig(**TINY_MM, dtype="float32"),
                          max_len=32), batch_size=2, max_len=32)
    x = (np.zeros((224, 224, 3)) if fn == "encode_image"
         else np.zeros((256, 128)))
    with pytest.raises(ValueError) as jerr:
        getattr(je, fn)(x)
    with pytest.raises(ValueError, match="multimodal") as terr:
        getattr(te, fn)(x)
    assert str(terr.value) == str(jerr.value)


def test_supports_on_both_towers():
    je, te = embedders()
    assert te.supports_audio and te.supports_images
    assert je.supports_audio and je.supports_images
    cfg = EncoderConfig(**TINY_MM, dtype="float32")
    text = Embedder(tenc.init_encoder(cfg, device="cpu"), batch_size=2,
                    max_len=32)
    assert not text.supports_audio and not text.supports_images
    assert isinstance(te.state.model, MultimodalEncoder)
    assert isinstance(te.state.model, tenc.TextEncoder)
    m = te.state.model
    assert (m.patch_size, m.image_size, m.audio_frames, m.audio_mels) == \
        (16, 224, 256, 128)


def test_multimodal_encoder_image_changes_embedding():
    """tests/test_models.py's case on the port: an image changes the
    pooled vector of the same text."""
    cfg = EncoderConfig(vocab_size=512, hidden_dim=32, num_layers=2,
                        num_heads=4, mlp_dim=64, max_len=32, out_dim=16,
                        dtype="float32")
    enc = tenc.init_encoder(cfg, max_len=16, multimodal=True, device="cpu")
    tok = HashTokenizer(cfg.vocab_size, 16)
    ids, mask = (torch.from_numpy(a) for a in
                 tok.encode_batch(["a page of text"]))
    o0 = enc.model.apply(enc.params, ids, mask, torch.zeros(1, 224, 224, 3))
    o1 = enc.model.apply(enc.params, ids, mask, torch.ones(1, 224, 224, 3))
    assert not np.allclose(o0.numpy(), o1.numpy())


def test_init_multimodal_seeded_and_scaled():
    """Seeded weights; the text part equals the text tower's of the same
    seed; flax's scales: conv kernels N(0, 1/fan_in), biases 0, the patch
    position tables N(0, 0.02^2); a text tree does not load into it."""
    cfg = EncoderConfig(**TINY_MM, dtype="float32")
    a = tenc.init_encoder(cfg, seed=7, multimodal=True, device="cpu")
    b = tenc.init_encoder(cfg, seed=7, multimodal=True, device="cpu")
    text = tenc.init_encoder(cfg, seed=7, device="cpu")
    for n, t in a.params.items():
        assert torch.equal(t, b.params[n]), n
    for n, t in text.params.items():
        assert torch.equal(t, a.params[n]), n
    assert a.params["patch_w"].shape == (768, 32)
    assert a.params["audio_patch_w"].shape == (256, 32)
    assert a.params["patch_pos"].shape == (196, 32)
    assert a.params["audio_patch_pos"].shape == (128, 32)
    assert abs(a.params["patch_w"].std().item() - 768 ** -0.5) < 0.005
    assert abs(a.params["audio_patch_w"].std().item() - 256 ** -0.5) < 0.01
    assert abs(a.params["patch_pos"].std().item() - 0.02) < 0.002
    assert not a.params["patch_b"].any() and not a.params["audio_patch_b"].any()
    js = j_init(JEncoderConfig(**TINY_MM, dtype="float32"), max_len=32)
    with pytest.raises(RuntimeError, match="Missing key"):
        a.model.load_state_dict(state.encoder_params_from_jax(
            jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    with pytest.raises(ValueError, match="patches"):
        a.model.apply(None, torch.zeros(1, 4, dtype=torch.long),
                      torch.ones(1, 4, dtype=torch.bool),
                      torch.zeros(1, 112, 112, 3))
