"""Parity of the port's decoder (`models.decoder`) with the JAX package's,
on the JAX weights carried across by `state.decoder_params_from_jax`.

Tolerances: float32 configs are held to rtol 1e-4 / atol 2e-4 on logits
(the reference's own kernel-vs-einsum bound, tests/test_decoder.py): the
two frameworks sum matmuls, norms and softmaxes in other orders. With an
int8 KV cache that f32 noise can move a K/V element across an int8
rounding edge (one step is 1/127 of its row's max), and the kernel
path's bf16 output across a bf16 one, which moves logits by up to ~1e-2
at these widths (measured 0.012 over three seeds): those configs are held
to 2^-5 absolute. Greedy tokens are identical wherever the JAX logits'
top two are further apart than twice the tolerance. The bf16 config is
held to 2^-4 absolute on logits of magnitude ~1: every activation there
is rounded to bf16 (2^-8 relative) at places the two frameworks choose
differently, and the noise adds up over the layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.models import decoder as jdec
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.state import decoder_params_from_jax

CFG = jdec.DecoderConfig(vocab_size=128, hidden=256, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=96, max_len=64,
                         dtype="float32")
TOL = dict(rtol=1e-4, atol=2e-4)
KV_TOL = dict(rtol=1e-4, atol=2.0 ** -5)


def assert_greedy_equal(t, j, atol):
    """argmax equal on every row whose top-two gap exceeds 2 * atol."""
    top2 = np.sort(j, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear])


def tcfg(cfg):
    """The port's DecoderConfig with the same fields."""
    return tdec.DecoderConfig(**dataclasses.asdict(cfg))


def carry(params, cfg):
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a

    tree = {k: ({kk: leaf(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in params.items()}
    return decoder_params_from_jax(tree, tcfg(cfg), device="cpu")


def jparams(cfg, seed=0, biases=False, quant=False):
    p = jdec.init_decoder_params(jax.random.PRNGKey(seed), cfg)
    if biases:  # Qwen2-family q/k/v projection biases
        r = np.random.default_rng(seed)
        L, hd = cfg.num_layers, cfg.head_dim
        for name, width in (("bq", cfg.heads), ("bk", cfg.kv_heads),
                            ("bv", cfg.kv_heads)):
            p[name] = jnp.asarray(0.1 * r.standard_normal((L, width * hd)),
                                  cfg.dtype)
    return jdec.quantize_decoder_params(p) if quant else p


def ragged_inputs(rng, B=3, T=16, S=64):
    ids = rng.integers(0, CFG.vocab_size, (B, T)).astype(np.int32)
    plen = np.asarray([16, 11, 7][:B], np.int32)
    s_idx = np.arange(S, dtype=np.int32)[None, :]
    slot_pos = np.where(s_idx < T,
                        np.where(s_idx < plen[:, None], s_idx, 2 ** 30),
                        plen[:, None] + (s_idx - T)).astype(np.int32)
    return ids, plen, slot_pos


def step_logits(cfg, jp, tp, ids, plen, slot_pos, steps=4):
    """Prefill + `steps` decode steps in both packages, feeding both the
    JAX greedy tokens; returns the lists of per-step logits."""
    B, T = ids.shape
    S = slot_pos.shape[1]
    t = tcfg(cfg)
    jk, jv = jdec.init_kv_cache(cfg, B, S)
    tk, tv = tdec.init_kv_cache(t, B, S, device="cpu")
    jl, jk, jv = jdec.prefill(jp, cfg, jnp.asarray(ids), jnp.asarray(plen),
                              jk, jv)
    tl, tk, tv = tdec.prefill(tp, t, torch.from_numpy(ids),
                              torch.from_numpy(plen), tk, tv)
    js, ts = [np.asarray(jl)], [tl.numpy()]
    pos = plen.copy()
    sp_j, sp_t = jnp.asarray(slot_pos), torch.from_numpy(slot_pos)
    for step in range(steps):
        tok = np.argmax(js[-1], -1).astype(np.int32)
        jl, jk, jv = jdec.decode_step(jp, cfg, jnp.asarray(tok),
                                      jnp.asarray(pos), T + step, jk, jv,
                                      slot_positions=sp_j)
        tl, tk, tv = tdec.decode_step(tp, t, torch.from_numpy(tok),
                                      torch.from_numpy(pos), T + step, tk, tv,
                                      slot_positions=sp_t)
        js.append(np.asarray(jl))
        ts.append(tl.numpy())
        pos = pos + 1
    return js, ts


@pytest.mark.parametrize("kv_quant,attn_kernel,quant,biases,rope", [
    (False, False, False, False, "none"),
    (False, True, False, True, "llama3"),
    (True, False, False, False, "linear"),
    (True, True, False, True, "none"),
    (False, False, True, True, "none"),
    (False, True, True, False, "linear"),
    (True, False, True, True, "llama3"),
    (True, True, True, False, "llama3"),
])
def test_prefill_and_decode_logits_match(kv_quant, attn_kernel, quant,
                                         biases, rope):
    cfg = dataclasses.replace(
        CFG, kv_quant=kv_quant, attn_kernel=attn_kernel, rope_kind=rope,
        rope_factor=4.0 if rope != "none" else 1.0,
        rope_original_max_len=32)
    jp = jparams(cfg, seed=1, biases=biases, quant=quant)
    tp = carry(jp, cfg)
    js, ts = step_logits(cfg, jp, tp, *ragged_inputs(np.random.default_rng(0)))
    tol = KV_TOL if kv_quant else TOL
    for j, t in zip(js, ts):
        np.testing.assert_allclose(t, j, **tol)
        assert_greedy_equal(t, j, tol["atol"])


def test_bf16_config_logits_close():
    cfg = dataclasses.replace(CFG, dtype="bfloat16", kv_quant=True,
                              attn_kernel=True)
    jp = jparams(cfg, seed=2, quant=True)
    tp = carry(jp, cfg)
    js, ts = step_logits(cfg, jp, tp, *ragged_inputs(np.random.default_rng(1)),
                         steps=2)
    for j, t in zip(js, ts):
        assert np.abs(t - j).max() <= 2.0 ** -4


def test_kernel_branch_is_taken_and_cache_written_in_place(monkeypatch):
    """T=1 steps on a tileable cache go through decode_attend_int8; the
    cache tensors are updated in place at the shared slot."""
    cfg = tcfg(dataclasses.replace(CFG, kv_quant=True, attn_kernel=True))
    tp = tdec.init_decoder_params(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    ck, cv = tdec.init_kv_cache(cfg, 2, 64, device="cpu")
    calls = []
    real = tdec._da.decode_attend_int8
    monkeypatch.setattr(tdec._da, "decode_attend_int8",
                        lambda *a: calls.append(1) or real(*a))
    ids = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32)
    _, ck2, cv2 = tdec.prefill(tp, cfg, ids, torch.tensor([8, 5]), ck, cv)
    assert ck2["q"] is ck["q"] and not calls  # prefill: einsum path
    q_before = ck["q"].clone()
    tdec.decode_step(tp, cfg, ids[:, 0], torch.tensor([8, 5]), 8, ck, cv)
    assert len(calls) == cfg.num_layers
    changed = (ck["q"] != q_before).any(-1).any(-1)  # (L, B, S)
    assert changed[:, :, 8].all() and not changed[:, :, 9:].any()
    assert not changed[:, :, :8].any()


def test_generate_greedy_identical_with_eos_latch():
    """Greedy generate on the main-path flags (int8 weights, int8 KV, the
    kernel branch) is token-identical to JAX across ragged prompts, with
    an eos that latches, and the log-probs agree."""
    cfg = dataclasses.replace(CFG, kv_quant=True, attn_kernel=True)
    jp = jparams(cfg, seed=3, quant=True)
    tp, t = carry(jp, cfg), tcfg(cfg)
    rng = np.random.default_rng(2)
    ids = np.zeros((3, 16), np.int32)
    plen = np.asarray([16, 9, 5], np.int32)
    for b, n in enumerate(plen):
        ids[b, :n] = rng.integers(1, CFG.vocab_size, n)
    key = jax.random.PRNGKey(0)
    jo, jn, jl = jdec.generate_logprobs(jp, cfg, ids, plen, 20,
                                        CFG.vocab_size, 0, key)
    to, tn, tl = tdec.generate_logprobs(tp, t, ids, plen, 20,
                                        CFG.vocab_size, 0)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **KV_TOL)
    # an eos that row 0 emits at step 3: row 0 stops there, pad after
    eos = int(np.asarray(jo)[0, 3])
    jo, jn = jdec.generate(jp, cfg, ids, plen, 20, eos, 0, key)
    to, tn = tdec.generate(tp, t, ids, plen, 20, eos, 0)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (to[0, 4:] == 0).all()


def test_done_check_interval_does_not_change_outputs(monkeypatch):
    """The loop reads `done.all()` on the host only every few steps; when
    every row has hit eos early the outputs are the same as with a read
    every step (and as JAX's while_loop, which stops at once)."""
    jp = jparams(CFG, seed=3)
    tp, t = carry(jp, CFG), tcfg(CFG)
    ids = np.full((2, 4), 5, np.int32)
    plen = np.asarray([4, 4], np.int32)
    key = jax.random.PRNGKey(0)
    free = np.asarray(jdec.generate(jp, CFG, ids, plen, 24, -1, 0, key)[0])
    eos = int(free[0, 1])  # both rows share the prompt: both stop at step 1
    jo, jn = jdec.generate(jp, CFG, ids, plen, 24, eos, 0, key)
    outs = []
    for every in (1, 8):
        monkeypatch.setattr(tdec, "_DONE_CHECK_EVERY", every)
        outs.append(tdec.generate(tp, t, ids, plen, 24, eos, 0))
    for to, tn in outs:
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (outs[0][0][:, 2:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_building_blocks_keep_the_rounding_points(dtype):
    """_mm and _take_emb cast the int8 scale to the activation dtype
    before the product, _rmsnorm multiplies its weight in f32 before the
    cast, _apply_rope casts cos/sin first, _kv_quantize divides: each
    equals JAX's on the same inputs, bit for bit in bf16 (where each of
    these choices shows). The _mm input is one-hot rows, so the product
    itself is exact in both and only the scale's rounding remains."""
    r = np.random.default_rng(8)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def both(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)

    def same(t, j, rtol=0.0, atol=0.0):
        if dtype == "float32":  # f32: the two frameworks' libm and sums
            rtol, atol = max(rtol, 2e-6), max(atol, 1e-6)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=rtol, atol=atol)

    w = r.standard_normal((64, 48)).astype(np.float32)
    wq_j = jdec.quantize_decoder_params({"wq": jnp.asarray(w)})["wq"]
    wq_t = tdec.quantize_decoder_params({"wq": torch.from_numpy(w)})["wq"]
    onehot_j, onehot_t = both(np.eye(64)[r.integers(0, 64, 9)])
    same(tdec._mm(onehot_t, wq_t), jdec._mm(onehot_j, wq_j))
    emb = r.standard_normal((40, 64)).astype(np.float32)
    ej = jdec.quantize_decoder_params({"tok_emb": jnp.asarray(emb)})
    et = tdec.quantize_decoder_params({"tok_emb": torch.from_numpy(emb)})
    ids = r.integers(0, 40, (2, 7)).astype(np.int32)
    same(tdec._take_emb(et["tok_emb"], torch.from_numpy(ids), tdt),
         jdec._take_emb(ej["tok_emb"], jnp.asarray(ids), jdt))
    x_j, x_t = both(r.standard_normal((3, 5, 64)))
    nw_j, nw_t = both(1 + 0.1 * r.standard_normal(64))
    same(tdec._rmsnorm(x_t, nw_t, 1e-5), jdec._rmsnorm(x_j, nw_j, 1e-5))
    pos = r.integers(0, 900, (3, 5)).astype(np.int32)
    cfg = dataclasses.replace(CFG, hidden=256, heads=4, dtype=dtype)
    cj, sj = jdec._rope(jnp.asarray(pos), cfg)
    ct, st = tdec._rope(torch.from_numpy(pos), tcfg(cfg))
    same(ct, cj, atol=2e-6)  # f32 cos of arguments up to ~900
    q_j, q_t = both(r.standard_normal((3, 5, 4, 64)))
    same(tdec._apply_rope(q_t, ct, st), jdec._apply_rope(q_j, cj, sj))
    kq_j = jdec._kv_quantize(q_j)
    kq_t = tdec._kv_quantize(q_t)
    np.testing.assert_array_equal(kq_t["q"].numpy(), np.asarray(kq_j["q"]))
    np.testing.assert_array_equal(kq_t["s"].numpy(), np.asarray(kq_j["s"]))


def test_penalties_and_logit_bias_greedy_identical():
    jp = jparams(CFG, seed=4)
    tp, t = carry(jp, CFG), tcfg(CFG)
    rng = np.random.default_rng(3)
    ids = rng.integers(1, CFG.vocab_size, (2, 8)).astype(np.int32)
    plen = np.asarray([8, 6], np.int32)
    bias = (rng.standard_normal(CFG.vocab_size) * 2).astype(np.float32)
    jo, jn = jdec.generate(jp, CFG, ids, plen, 12, -1, 0,
                           jax.random.PRNGKey(0), 0.0, 64, 1.0, None, 0.7,
                           0.4, None, jnp.asarray(bias))
    to, tn = tdec.generate(tp, t, ids, plen, 12, -1, 0, None, 0.0, 64, 1.0,
                           None, 0.7, 0.4, None, bias)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_score_continuations_close():
    jp = jparams(CFG, seed=5)
    tp, t = carry(jp, CFG), tcfg(CFG)
    rng = np.random.default_rng(4)
    ids = rng.integers(1, CFG.vocab_size, (3, 12)).astype(np.int32)
    plen = np.asarray([5, 5, 5], np.int32)
    tot = np.asarray([9, 12, 7], np.int32)
    j = np.asarray(jdec.score_continuations(jp, CFG, jnp.asarray(ids),
                                            jnp.asarray(plen),
                                            jnp.asarray(tot)))
    out = tdec.score_continuations(tp, t, ids, plen, tot).numpy()
    np.testing.assert_allclose(out, j, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal(dtype):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    jp = jparams(cfg, seed=6, biases=True)
    jq = jdec.quantize_decoder_params(jp)
    tq = tdec.quantize_decoder_params(carry(jp, cfg))
    assert set(tq) == set(jq)
    for name, leaf in jq.items():
        if isinstance(leaf, dict):
            np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                          np.asarray(leaf["q"]))
            np.testing.assert_array_equal(tq[name]["s"].numpy(),
                                          np.asarray(leaf["s"]))
        else:
            np.testing.assert_array_equal(tq[name].float().numpy(),
                                          np.asarray(leaf, np.float32))


@pytest.mark.parametrize("tied,biases", [(False, True), (True, False)])
def test_convert_hf_state_dict_matches(tied, biases):
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    rng = np.random.default_rng(7)
    H, hd, M = cfg.hidden, cfg.head_dim, cfg.mlp_dim
    sd = {"model.embed_tokens.weight":
          rng.standard_normal((cfg.vocab_size, H)).astype(np.float32),
          "model.norm.weight": rng.standard_normal(H).astype(np.float32)}
    if not tied:
        sd["lm_head.weight"] = rng.standard_normal(
            (cfg.vocab_size, H)).astype(np.float32)
    shapes = {"self_attn.q_proj": (cfg.heads * hd, H),
              "self_attn.k_proj": (cfg.kv_heads * hd, H),
              "self_attn.v_proj": (cfg.kv_heads * hd, H),
              "self_attn.o_proj": (H, cfg.heads * hd),
              "mlp.gate_proj": (M, H), "mlp.up_proj": (M, H),
              "mlp.down_proj": (H, M)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for name, shape in shapes.items():
            sd[pre + name + ".weight"] = rng.standard_normal(shape).astype(
                np.float32)
            if biases and name in ("self_attn.q_proj", "self_attn.k_proj",
                                   "self_attn.v_proj"):
                sd[pre + name + ".bias"] = rng.standard_normal(
                    shape[0]).astype(np.float32)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + norm + ".weight"] = rng.standard_normal(H).astype(
                np.float32)
    j = jdec.convert_hf_llama_state_dict(sd, cfg)
    t = tdec.convert_hf_llama_state_dict(sd, tcfg(cfg), device="cpu")
    assert set(t) == set(j) and (("bq" in t) == biases)
    for name in j:
        assert t[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(t[name].float().numpy(),
                                      np.asarray(j[name], np.float32))


def test_sampled_generate_follows_the_law(monkeypatch):
    """Sampled generate: the same Generator seed gives the same tokens,
    and every token lies inside its step's top-k / top-p set."""
    cfg = tcfg(dataclasses.replace(CFG, kv_quant=True, attn_kernel=True))
    tp = tdec.init_decoder_params(torch.Generator().manual_seed(1), cfg,
                                  device="cpu")
    ids = torch.randint(1, cfg.vocab_size, (4, 8),
                        generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    plen = torch.tensor([8, 8, 6, 3], dtype=torch.int32)
    temp, top_k, top_p = 1.5, 8, 0.8
    seen = []
    real = tdec.sample_logits

    def record(logits, gen, **kw):
        tok = real(logits, gen, **kw)
        seen.append((logits.clone(), tok.clone()))
        return tok

    monkeypatch.setattr(tdec, "sample_logits", record)
    outs = [tdec.generate(tp, cfg, ids, plen, 10, -1, 0,
                          torch.Generator().manual_seed(seed), temp, top_k,
                          top_p)[0] for seed in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert len(seen) == 3 * 11  # first token + one per decode step
    for logits, tok in seen:
        vals, idx = torch.topk(logits / temp, top_k)
        probs = torch.softmax(vals, -1)
        keep = (torch.cumsum(probs, -1) - probs) < top_p
        for b in range(logits.shape[0]):
            assert int(tok[b]) in idx[b][keep[b]].tolist()
