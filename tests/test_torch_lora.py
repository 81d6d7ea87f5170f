"""Parity of the port's LoRA adapters (`models/lora.py` and the decoder's
LoRA paths) with the JAX package's, case for case with
tests/test_lora.py, on weights carried by `state.decoder_params_from_jax`
(a wrapped tree's factors too) and `state.adapters_from_jax`.

Tolerances (float32 decoder configs):

  * logits: rtol 1e-4 / atol 2e-4, as tests/test_torch_decoder.py states;
    2^-5 absolute with an int8 KV cache on the decode kernel's branch;
  * wrapped against merged forwards: 2e-3 of the largest logit, the
    reference's own bound (the merge rounds w + a @ b * s once, the
    wrapped forward rounds three products); 2^-5 of it over an int8
    base, whose merge is rounded to bf16 (2^-9 relative a weight);
  * merged weights against the JAX merge: float32 bases within 1e-6 of
    the largest element (the (L, in, r) @ (L, r, out) product sums in
    another order); bf16 results (int8 bases) within one bf16 ulp;
  * banks, npz files and loaded factors: bit for bit;
  * the LoRA step: loss rtol 1e-5; the adapter gradients are bf16 (the
    factors' dtype) and agree within one bf16 ulp of each element plus
    1e-4 of the leaf's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models import lora as jlora
from rag_application_tpu.models.train import TrainState as JTrainState
from rag_application_tpu_torch import state
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models import lora as tlora
from rag_application_tpu_torch.models import train as ttrain

CFG = jdec.DecoderConfig(vocab_size=64, hidden=32, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=64, max_len=64, dtype="float32")
# the decode kernel's branch: kv_heads * head_dim % 128 == 0
KCFG = dataclasses.replace(CFG, hidden=256, kv_quant=True, attn_kernel=True)
BASE = jdec.init_decoder_params(jax.random.PRNGKey(0), CFG)
TOL = dict(rtol=1e-4, atol=2e-4)


def tcfg(cfg=CFG):
    return tdec.DecoderConfig(**dataclasses.asdict(cfg))


def np_tree(tree):
    """A JAX tree as numpy, bf16 leaves as their uint16 bits."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def carry(params, cfg=CFG):
    return state.decoder_params_from_jax(np_tree(params), tcfg(cfg), "cpu")


def perturbed(wrapped, seed, scale=0.03):
    """The wrapped tree with nonzero factors (b != 0), as the reference's
    tests make them."""
    key = jax.random.PRNGKey(seed)
    ads = jax.tree.map(lambda v: v + scale * jax.random.normal(
        key, v.shape, jnp.float32).astype(v.dtype), jlora.lora_adapters(wrapped))
    return jlora.lora_apply(wrapped, ads)


def j_logits(params, ids, cfg=CFG):
    ck, cv = jdec.init_kv_cache(cfg, ids.shape[0])
    return np.asarray(jdec.prefill(params, cfg, jnp.asarray(ids),
                                   jnp.asarray([ids.shape[1]] * ids.shape[0]),
                                   ck, cv)[0])


def t_logits(params, ids, cfg=CFG, lora=None):
    ck, cv = tdec.init_kv_cache(tcfg(cfg), ids.shape[0], device="cpu")
    with torch.no_grad():
        out = tdec.prefill(params, tcfg(cfg), torch.from_numpy(ids),
                           torch.tensor([ids.shape[1]] * ids.shape[0],
                                        dtype=torch.int32), ck, cv,
                           lora=lora)[0]
    return out.numpy()


def ids_of(seed, B, T):
    return np.random.default_rng(seed).integers(0, 64, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("quant", [False, True])
def test_init_is_identity(quant):
    """b = 0 at init: the wrapped model IS the base model, bit for bit,
    over a plain and an int8 base; the factors' law and layout follow the
    reference (a ~ N(0, 1/in) in bf16, b = 0, s = alpha / r)."""
    base = carry(jdec.quantize_decoder_params(BASE) if quant else BASE)
    gen = torch.Generator().manual_seed(1)
    wrapped = tlora.lora_init(gen, base, r=4, alpha=8.0)
    jw = jlora.lora_init(jax.random.PRNGKey(1), BASE, r=4, alpha=8.0)
    for t in tlora.DEFAULT_TARGETS:
        for k in ("a", "b", "s"):
            assert wrapped[t][k].shape == jw[t][k].shape
            assert str(wrapped[t][k].dtype).split(".")[-1] == str(
                jw[t][k].dtype)
        assert (wrapped[t]["b"] == 0).all()
        assert (wrapped[t]["s"] == 2.0).all()
        assert wrapped[t]["w"] is base[t]
        fan_in = wrapped[t]["a"].shape[1]
        assert abs(float(wrapped[t]["a"].float().std()) * np.sqrt(fan_in)
                   - 1.0) < 0.15
    ids = ids_of(0, 2, 9)
    assert (t_logits(wrapped, ids) == t_logits(base, ids)).all()


@pytest.mark.parametrize("quant", [False, True])
def test_merge_matches_wrapped_and_reference(quant):
    """With nonzero factors: the port's wrapped forward equals the JAX
    wrapped forward; the port's merge equals the JAX merge of the carried
    tree and computes the wrapped function."""
    base = jdec.quantize_decoder_params(BASE) if quant else BASE
    jw = perturbed(jlora.lora_init(jax.random.PRNGKey(2), base, r=4), 2)
    tw = carry(jw)
    ids = ids_of(1, 2, 7)
    lw = t_logits(tw, ids)
    np.testing.assert_allclose(lw, j_logits(jw, ids), **TOL)
    tm, jm = tlora.lora_merge(tw), jlora.lora_merge(jw)
    for t in tlora.DEFAULT_TARGETS:
        assert not isinstance(tm[t], dict)
        want = np.asarray(jm[t], np.float32)
        got = tm[t].float().numpy()
        if quant:
            assert tm[t].dtype == torch.bfloat16 and jm[t].dtype == jnp.bfloat16
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all(), t
        else:
            assert tm[t].dtype == torch.float32
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    lm = t_logits(tm, ids)
    np.testing.assert_allclose(lm, j_logits(jm, ids), **TOL)
    # an int8 base folds to bf16, which rounds every merged weight
    bound = 2.0 ** -5 if quant else 2e-3
    np.testing.assert_allclose(lm, lw, atol=bound * max(np.abs(lw).max(), 1))


def adapter_trees(params, seed=9):
    """Two adapter trees for ``params``' widths, of other ranks (one
    without "wv", one without a stored scale), as float32 JAX arrays."""
    key = jax.random.PRNGKey(seed)
    trees = []
    for r, targets, with_s in ((4, ("wq", "wv"), True),
                               (8, ("wq", "wo"), False)):
        tree = {}
        for t in targets:
            leaf = params[t]["q"] if isinstance(params[t], dict) else params[t]
            L, fin, fout = leaf.shape
            key, k1, k2 = jax.random.split(key, 3)
            tree[t] = {"a": jax.random.normal(k1, (L, fin, r)) * 0.3,
                       "b": jax.random.normal(k2, (L, r, fout)) * 0.3}
            if with_s:
                tree[t]["s"] = jnp.full((L, 1, 1), 2.0, jnp.float32)
        trees.append(tree)
    return trees


def both_banks(trees, dtype):
    jb = jlora.lora_banks(trees, alpha=12.0, dtype=jnp.dtype(dtype))
    tb = tlora.lora_banks([state.adapters_from_jax(np_tree(t), "cpu")
                           for t in trees], alpha=12.0,
                          dtype=getattr(torch, dtype))
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_banks_match_reference(dtype):
    jb, tb = both_banks(adapter_trees(BASE), dtype)
    assert tb.keys() == jb.keys() == {"wq", "wv", "wo"}
    for t in jb:
        for k in ("a", "b"):
            assert tuple(tb[t][k].shape) == jb[t][k].shape
            assert tb[t][k].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(tb[t][k].float().numpy(),
                                          np.asarray(jb[t][k], np.float32))
    assert tlora.lora_banks([]) == {} == jlora.lora_banks([])


@pytest.mark.parametrize("kernel", [False, True])
def test_forward_with_banks_matches_reference(kernel):
    """`forward(lora=...)` with mixed adapter ids per row (base, the
    second adapter, the first) against the reference: the prefill's
    logits, then two decode steps — on the einsum path, or with an int8
    KV cache on the decode kernel's branch."""
    cfg = KCFG if kernel else CFG
    jp = jdec.init_decoder_params(jax.random.PRNGKey(0), cfg)
    jb, tb = both_banks(adapter_trees(jp), "float32")
    aid = np.asarray([0, 2, 1], np.int32)
    jl = {"aid": jnp.asarray(aid), "banks": jb}
    tl = {"aid": torch.from_numpy(aid), "banks": tb}
    tp, tc = carry(jp, cfg), tcfg(cfg)
    ids = ids_of(2, 3, 8)
    B, T, S = 3, 8, 256 if kernel else 16
    jk, jv = jdec.init_kv_cache(cfg, B, S)
    tk, tv = tdec.init_kv_cache(tc, B, S, device="cpu")
    plen = np.full((B,), T, np.int32)
    jlog, jk, jv = jdec.prefill(jp, cfg, jnp.asarray(ids), jnp.asarray(plen),
                                jk, jv, lora=jl)
    with torch.no_grad():
        tlog, tk, tv = tdec.prefill(tp, tc, torch.from_numpy(ids),
                                    torch.from_numpy(plen), tk, tv, lora=tl)
    tol = dict(rtol=1e-4, atol=2.0 ** -5) if kernel else TOL
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    tok = np.zeros((B,), np.int32)  # every row decodes the same token
    for step in range(2):
        pos = np.full((B,), T + step, np.int32)
        jlog, jk, jv = jdec.decode_step(jp, cfg, jnp.asarray(tok),
                                        jnp.asarray(pos), T + step, jk, jv,
                                        lora=jl)
        with torch.no_grad():
            tlog, tk, tv = tdec.decode_step(
                tp, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                T + step, tk, tv, lora=tl)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    # the adapters act: with the same prompt and tokens the rows differ
    same = ids_of(2, 1, 8).repeat(3, axis=0)
    ck, cv = tdec.init_kv_cache(tc, B, S, device="cpu")
    with torch.no_grad():
        lg = tdec.prefill(tp, tc, torch.from_numpy(same),
                          torch.from_numpy(plen), ck, cv, lora=tl)[0].numpy()
    assert not np.allclose(lg[0], lg[1]) and not np.allclose(lg[0], lg[2])


def capture():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_lora_train_step_matches_reference(quant, remat):
    """`make_lora_train_step`: the loss and the (bf16) adapter gradients
    against the reference's step on the carried wrapped tree."""
    base = jdec.quantize_decoder_params(BASE) if quant else BASE
    jw = perturbed(jlora.lora_init(jax.random.PRNGKey(5), base, r=4), 5)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (4, 12)).astype(np.int32)
    mask = np.arange(12)[None, :] < np.asarray([12, 10, 7, 12])[:, None]
    batch = {"ids": ids, "mask": mask}
    ads = jlora.lora_adapters(jw)
    st = JTrainState(params=ads, opt_state=capture().init(ads),
                     step=jnp.zeros((), jnp.int32))
    jst, jm = jax.jit(jlora.make_lora_train_step(CFG, capture(),
                                                 remat=remat))(
        st, jw, {k: jnp.asarray(v) for k, v in batch.items()})
    tw = carry(jw)
    opt = ttrain.make_optimizer(lr=1e-3)
    tst = ttrain.init_train_state(tlora.lora_adapters(tw), opt)
    tst, tm = tlora.make_lora_train_step(tcfg(), opt, remat=remat)(
        tst, tw, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    want = state.adapters_to_numpy(state.adapters_from_jax(
        np_tree(jst.opt_state), "cpu"))
    for t, ab in tst.params.items():
        for k, p in ab.items():
            assert p.grad.dtype == torch.bfloat16
            g, w = p.grad.float().numpy(), want[t][k]
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                      1e-30))) - 7)
            assert (np.abs(g - w) <= ulp + 1e-4 * np.abs(w).max()).all(), \
                (t, k)


def test_lora_overfits_with_frozen_base():
    """Adapter-only training drives next-token accuracy on a fixed
    sequence toward 1 while every base weight stays bit-identical, and
    generation completes the memorized sequence (the reference's case,
    on the port alone)."""
    seq = np.asarray([1, 7, 3, 9, 2, 8, 4, 6] * 2, np.int32)
    batch = {"ids": np.tile(seq, (4, 1)), "mask": np.ones((4, 16), bool)}
    base = carry(BASE)
    snapshot = {k: v.clone() for k, v in base.items()}
    wrapped = tlora.lora_init(torch.Generator().manual_seed(3), base, r=8,
                              alpha=16.0)
    opt = ttrain.make_optimizer(lr=3e-2)
    step = tlora.make_lora_train_step(tcfg(), opt, remat=False)
    st = ttrain.init_train_state(tlora.lora_adapters(wrapped), opt)
    first = None
    for _ in range(120):
        st, m = step(st, wrapped, batch)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < 0.35 * first
    assert float(m["accuracy"]) > 0.8
    for k, v in snapshot.items():
        assert torch.equal(base[k], v), k
    trained = tlora.lora_apply(wrapped, st.params)
    for name in tlora.DEFAULT_TARGETS:
        assert trained[name]["w"] is base[name]
    assert not (trained["wq"]["b"] == 0).all()
    assert (wrapped["wq"]["b"] == 0).all()  # init_train_state copied
    out, _ = tdec.generate(trained, tcfg(), seq[None, :8], np.asarray([8]),
                           8, -1, 0)
    assert (out[0].numpy() == seq[8:]).mean() > 0.7


def test_adapter_npz_crosses_packages(tmp_path):
    """npz written by the JAX `save_adapters` loads bit-equal in the port
    (as the JAX `load_adapters` loads it), and the port's file loads
    bit-equal in JAX; scales ride along where given."""
    jw = perturbed(jlora.lora_init(jax.random.PRNGKey(6), BASE, r=4), 6, 1.0)
    jads = jlora.lora_adapters(jw)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jlora.save_adapters(jads, jpath, wrapped=jw)
    for dtype in ("bfloat16", "float32"):
        got = tlora.load_adapters(jpath, dtype=getattr(torch, dtype),
                                  device="cpu")
        want = jlora.load_adapters(jpath, dtype=jnp.dtype(dtype))
        assert got.keys() == want.keys()
        for t in want:
            assert got[t].keys() == want[t].keys() == {"a", "b", "s"}
            for k in want[t]:
                np.testing.assert_array_equal(
                    np_tree(want[t][k]),
                    np_tree(jnp.asarray(state.adapters_to_numpy(
                        {t: {k: got[t][k]}})[t][k]).astype(want[t][k].dtype)))
    tw = carry(jw)
    tlora.save_adapters(tlora.lora_adapters(tw), tpath, wrapped=tw)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    tlora.save_adapters(tlora.lora_adapters(tw), tpath)  # no scales
    back = jlora.load_adapters(tpath)
    assert all(set(ab) == {"a", "b"} for ab in back.values())


def test_saved_scale_wins_over_alpha_fallback(tmp_path):
    """The npz embeds the trained scale s = alpha / r, so serving with
    another alpha still applies the adapter at its trained strength."""
    base = carry(BASE)
    wrapped = tlora.lora_init(torch.Generator().manual_seed(7), base, r=4,
                              alpha=32.0)
    ads = {t: {k: v + 0.05 for k, v in ab.items()}
           for t, ab in tlora.lora_adapters(wrapped).items()}
    wrapped = tlora.lora_apply(wrapped, ads)
    p = str(tmp_path / "a32.npz")
    tlora.save_adapters(tlora.lora_adapters(wrapped), p, wrapped=wrapped)
    rewrapped = tlora.lora_wrap_with(base, tlora.load_adapters(p,
                                                               device="cpu"),
                                     alpha=16.0)
    assert float(rewrapped["wq"]["s"][0, 0, 0]) == 32.0 / 4
    fallback = tlora.lora_wrap_with(base, {t: {"a": ab["a"], "b": ab["b"]}
                                           for t, ab in ads.items()},
                                    alpha=16.0)
    assert float(fallback["wq"]["s"][0, 0, 0]) == 16.0 / 4
    ids = ids_of(4, 1, 5)
    lw, lr = t_logits(wrapped, ids), t_logits(rewrapped, ids)
    np.testing.assert_allclose(lr, lw, atol=2e-3 * max(np.abs(lw).max(), 1))
