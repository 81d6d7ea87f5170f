"""Parity of the port's training steps (`models/train.py`) with the JAX
package's, on the same seeded inputs and carried weights
(`state.encoder_params_from_jax`, `state.decoder_params_from_jax`).

Gradients of the reference's own step functions are read by running
them with an optax transformation whose state becomes the gradients
(`capture`); the port's stay in each trainable tensor's ``.grad`` after
a step. Tolerances:

  * losses on the same (za, zb): 1e-6 relative;
  * the encoder step at float32: loss 1e-5 relative, every gradient
    leaf within 1e-4 of its leaf's largest magnitude (the two frameworks
    sum matmuls, norms and softmaxes in other orders);
  * the encoder step at bf16: loss 2e-2 relative, the whole gradient's
    relative L2 error under 6e-2 and each leaf's under 0.15 —
    activations are rounded to bf16 (2^-8 relative) at places the two
    frameworks choose differently, and the noise adds up through the
    backward pass; small leaves whose gradient is a near-cancelling sum
    (biases) see the most (measured over three seeds and two batches:
    loss up to 5.9e-3, whole gradient up to 0.029, a leaf up to 0.055);
  * three AdamW steps of the LM step at float32 (lr 1e-2): parameters
    within 3e-5 absolute of optax's, a thousandth of the most Adam can
    move an element in three steps (3 lr); the rounding of the update
    differs (`models/train.py`), measured 8.8e-6;
  * the LM step at float32: loss 1e-5 relative, gradients within 1e-4
    of each leaf's largest magnitude; the port's remat and non-remat
    steps give bit-equal losses and gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models import train as jtrain
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import EncoderConfig
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models import train as ttrain
from rag_application_tpu_torch.models.encoder import init_encoder

TINY = dict(vocab_size=128, hidden_dim=32, num_layers=2, num_heads=4,
            mlp_dim=64, max_len=16, out_dim=16)
DCFG = jdec.DecoderConfig(vocab_size=96, hidden=32, num_layers=2, heads=4,
                          kv_heads=2, mlp_dim=64, max_len=32,
                          dtype="float32")


def capture():
    """optax transformation: updates are zero and the new optimizer
    state is the gradient tree, so one step returns the reference's
    gradients unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def carried_encoder(dtype, seed=1):
    """(JAX EncoderState, port EncoderState, port config) with the same
    weights."""
    js = j_init(JEncoderConfig(**TINY, dtype=dtype), max_len=16, seed=seed)
    cfg = EncoderConfig(**TINY, dtype=dtype)
    ts = init_encoder(cfg, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return js, ts, cfg


def enc_batch(seed, b=8, L=16):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, L + 1, (2, b))
    mask = np.arange(L)[None, None, :] < lens[..., None]
    ids = rng.integers(0, TINY["vocab_size"], (2, b, L)).astype(np.int32)
    return {"ids_a": ids[0], "mask_a": mask[0],
            "ids_b": ids[1], "mask_b": mask[1]}


def jax_step(fn, params, opt, batch):
    st = jtrain.TrainState(params=params, opt_state=opt.init(params),
                           step=jnp.zeros((), jnp.int32))
    return jax.jit(fn)(st, {k: jnp.asarray(v) for k, v in batch.items()})


def close_to_scale(got, want, rel):
    """Every element within ``rel`` of the leaf's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("dims", [(), (4, 8), (4, 4, 8, 16, 99)])
def test_losses_match_reference(dims):
    rng = np.random.default_rng(0)
    za = rng.standard_normal((8, 16)).astype(np.float32)
    zb = (za + 0.5 * rng.standard_normal((8, 16))).astype(np.float32)
    if dims:
        want = jtrain.matryoshka_contrastive_loss(za, zb, dims)
        got = ttrain.matryoshka_contrastive_loss(
            torch.from_numpy(za), torch.from_numpy(zb), dims)
    else:
        want = jtrain.contrastive_loss(za, zb)
        got = ttrain.contrastive_loss(torch.from_numpy(za),
                                      torch.from_numpy(zb))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_contrastive_loss_perfect_alignment():
    z = torch.eye(4)
    assert float(ttrain.contrastive_loss(z, z, temperature=0.01)) < 0.01


@pytest.mark.parametrize("dims", [(), (4, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(dtype, dims):
    """`make_train_step`: loss, accuracy and every gradient leaf against
    the reference's step on the same weights and batch."""
    js, ts, cfg = carried_encoder(dtype)
    batch = enc_batch(2)
    jst, jm = jax_step(jtrain.make_train_step(js.model, capture(),
                                              matryoshka_dims=dims),
                       js.params, capture(), batch)
    opt = ttrain.make_optimizer(lr=1e-3)
    tst = ttrain.init_train_state(ts.params, opt)
    tst, tm = ttrain.make_train_step(ts.model, opt, matryoshka_dims=dims)(
        tst, batch)
    want_g = state.encoder_params_from_jax(
        jax.tree.map(lambda g: np.asarray(g, np.float32), jst.opt_state),
        cfg, "cpu")
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    if dtype == "float32":
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for name, p in tst.params.items():
            close_to_scale(p.grad.numpy(), want_g[name].numpy(), 1e-4)
    else:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-2)
        diff = total = 0.0
        for name, p in tst.params.items():
            g, w = p.grad.numpy(), want_g[name].numpy()
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err < 0.15, (name, err)
            diff += np.linalg.norm(g - w) ** 2
            total += np.linalg.norm(w) ** 2
        assert np.sqrt(diff / total) < 6e-2
    # the served module's own weights are untouched by the step
    for name, p in ts.model.named_parameters():
        assert p.grad is None and not p.requires_grad
        torch.testing.assert_close(p, ts.params[name], rtol=0, atol=0)


def test_adamw_matches_optax():
    """Three AdamW steps (lr 1e-2, weight decay 0.1) of the LM step:
    every parameter within 3e-5 of optax.adamw's. (The decoder, not the
    encoder: the encoder's key bias has an analytically zero gradient —
    softmax ignores a shift shared by every key — so Adam's normalized
    update there is the sign of rounding noise in either framework.)"""
    jp = jdec.init_decoder_params(jax.random.PRNGKey(4), DCFG)
    jopt = optax.adamw(1e-2, weight_decay=0.1)
    jfn = jax.jit(jtrain.make_lm_train_step(DCFG, jopt, remat=False))
    jst = jtrain.TrainState(params=jp, opt_state=jopt.init(jp),
                            step=jnp.zeros((), jnp.int32))
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(DCFG))
    opt = ttrain.make_optimizer(lr=1e-2, weight_decay=0.1)
    tfn = ttrain.make_lm_train_step(tcfg, opt, remat=False)
    tst = ttrain.init_train_state(_carry_decoder(jp), opt)
    for k in range(3):
        batch = lm_batch(10 + k)
        jst, jm = jfn(jst, {n: jnp.asarray(v) for n, v in batch.items()})
        tst, tm = tfn(tst, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    want = _carry_decoder(jst.params)
    assert tst.step == int(jst.step) == 3
    for name, p in tst.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=3e-5)


@pytest.mark.parametrize("dims, lr", [((), 1e-3), ((4, 8), 1e-2)])
def test_train_loss_decreases(dims, lr):
    _, ts, _ = carried_encoder("float32")
    opt = ttrain.make_optimizer(lr=lr)
    step = ttrain.make_train_step(ts.model, opt, matryoshka_dims=dims)
    st = ttrain.init_train_state(ts.params, opt)
    batch = enc_batch(4)
    batch["ids_b"], batch["mask_b"] = batch["ids_a"], batch["mask_a"]
    losses = []
    for _ in range(8):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert st.step == 8


def test_train_state_checkpoint_roundtrip(tmp_path):
    _, ts, _ = carried_encoder("float32")
    opt = ttrain.make_optimizer(lr=1e-3)
    step = ttrain.make_train_step(ts.model, opt)
    st = ttrain.init_train_state(ts.params, opt)
    batch = enc_batch(5)
    st, _ = step(st, batch)
    path = str(tmp_path / "ckpt.pt")
    ttrain.save_train_state(st, path)
    template = ttrain.init_train_state(ts.params, opt)
    restored = ttrain.load_train_state(path, opt, template)
    assert restored.step == 1
    for name, p in st.params.items():
        assert torch.equal(restored.params[name], p.detach())
    # continuing from the restored state is continuing from the original
    s1, m1 = step(st, batch)
    s2, m2 = step(restored, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for name, p in s1.params.items():
        assert torch.equal(s2.params[name], p)


def _carry_decoder(params):
    return state.decoder_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()},
        tdec.DecoderConfig(**dataclasses.asdict(DCFG)), "cpu")


def lm_batch(seed, B=3, T=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, DCFG.vocab_size, (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.asarray([T, 9, 5])[:B, None]
    return {"ids": np.where(mask, ids, 0).astype(np.int32), "mask": mask}


def test_lm_train_step_matches_reference():
    """`make_lm_train_step` against the reference at float32, remat on
    and off; the port's two are bit-equal."""
    jp = jdec.init_decoder_params(jax.random.PRNGKey(3), DCFG)
    batch = lm_batch(6)
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(DCFG))
    outs = {}
    for remat in (True, False):
        jst, jm = jax_step(jtrain.make_lm_train_step(DCFG, capture(),
                                                     remat=remat),
                           jp, capture(), batch)
        want_g = _carry_decoder(jst.opt_state)
        opt = ttrain.make_optimizer(lr=1e-3)
        tst = ttrain.init_train_state(_carry_decoder(jp), opt)
        tst, tm = ttrain.make_lm_train_step(tcfg, opt, remat=remat)(tst,
                                                                    batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        for name, p in tst.params.items():
            close_to_scale(p.grad.numpy(), want_g[name].numpy(), 1e-4)
        outs[remat] = (tm["loss"], {n: p.grad for n, p in
                                    tst.params.items()})
    assert torch.equal(outs[True][0], outs[False][0])
    for name, g in outs[True][1].items():
        assert torch.equal(g, outs[False][1][name]), name


def test_lm_train_loss_decreases():
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(DCFG))
    gen = torch.Generator().manual_seed(0)
    opt = ttrain.make_optimizer(lr=3e-3)
    st = ttrain.init_train_state(tdec.init_decoder_params(gen, tcfg, "cpu"),
                                 opt)
    step = ttrain.make_lm_train_step(tcfg, opt)
    batch = lm_batch(8)
    first = None
    for _ in range(6):
        st, m = step(st, batch)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < first


def test_kv_quant_config_cannot_train():
    tcfg = tdec.DecoderConfig(**{**dataclasses.asdict(DCFG),
                                 "kv_quant": True})
    gen = torch.Generator().manual_seed(0)
    opt = ttrain.make_optimizer()
    st = ttrain.init_train_state(tdec.init_decoder_params(gen, tcfg, "cpu"),
                                 opt)
    with pytest.raises(ValueError, match="kv_quant"):
        ttrain.make_lm_train_step(tcfg, opt)(st, lm_batch(1))
