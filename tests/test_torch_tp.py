"""Parity of the port's tensor parallelism (`parallel/tp.py` and the
decoder, encoder, training, LoRA and batcher code that takes its sharded
trees) with the JAX package's ``jax.device_put(params,
param_shardings(mesh, params))``, on the same numpy weights.

The JAX side runs on conftest's 8 virtual CPU devices; the port's mesh is
``make_mesh(8, model=m, devices=[cpu] * 8)``. Shapes are the JAX tests'
tiny configs (hidden 32, 2 layers, 4 heads, 2 KV heads, float32).
Tolerances:

  * placement and `gather_params`: bit for bit;
  * prefill logits: atol 2e-4, rtol 1e-4 (tests/test_decoder.py's TP
    test), against the JAX sharded prefill and the port on one device;
  * greedy tokens (generate, the batcher): equal;
  * the DP x TP LM step: loss 1e-5, updated params 2e-5
    (tests/test_decoder.py's), replicas bit-equal;
  * the encoder's DP x TP step: loss rtol 1e-5 and updated params within
    2e-5, except the key third of each q/k/v bias, whose true gradient is
    zero (a softmax ignores a shift shared by every key): Adam turns its
    rounding noise into a step of up to lr in either direction, so those
    elements are held to 2 lr;
  * the sharded LoRA step: loss rtol 1e-5 and ``wq.b`` atol 1e-5
    (tests/test_lora.py's) against the port's one-device step; against
    the JAX sharded step ``wq.b`` within 1e-5 plus one bf16 ulp of its
    largest element, as the port's one-device step differs from the
    JAX one-device step (measured 1.53e-5, two ulps of ~1e-3: torch's
    AdamW rounds its bf16 moments at other points than optax,
    models/train.py).
"""

import asyncio
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models import lora as jlora
from rag_application_tpu.models import train as jtrain
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.parallel.mesh import make_mesh as j_mesh
from rag_application_tpu.parallel.mesh import param_shardings as j_rule
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import EncoderConfig
from rag_application_tpu_torch.llm.scheduler import ContinuousBatcher
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models import lora as tlora
from rag_application_tpu_torch.models import train as ttrain
from rag_application_tpu_torch.models.encoder import init_encoder
from rag_application_tpu_torch.ops import decode_attn as da
from rag_application_tpu_torch.parallel import tp
from rag_application_tpu_torch.parallel.mesh import make_mesh, param_shardings

CPU = torch.device("cpu")
CFG = jdec.DecoderConfig(vocab_size=64, hidden=32, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=64, max_len=32, dtype="float32")
# the decode kernel's branch: kv_heads * head_dim % 128 == 0
KCFG = dataclasses.replace(CFG, hidden=256, kv_quant=True, attn_kernel=True)
TOL = dict(atol=2e-4, rtol=1e-4)


def tcfg(cfg=CFG):
    return tdec.DecoderConfig(**dataclasses.asdict(cfg))


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@functools.lru_cache(maxsize=None)
def jparams(kind, cfg=CFG):
    """The JAX decoder tree: plain, int8 or LoRA-wrapped (nonzero b)."""
    p = jdec.init_decoder_params(jax.random.PRNGKey(0), cfg)
    if kind == "int8":
        return jdec.quantize_decoder_params(p)
    if kind == "lora":
        w = jlora.lora_init(jax.random.PRNGKey(5), p, r=4)
        ads = jax.tree.map(lambda v: v + 0.03 * jax.random.normal(
            jax.random.PRNGKey(5), v.shape, jnp.float32).astype(v.dtype),
            jlora.lora_adapters(w))
        return jlora.lora_apply(w, ads)
    return p


@functools.lru_cache(maxsize=None)
def tparams(kind, cfg=CFG):
    return state.decoder_params_from_jax(np_tree(jparams(kind, cfg)),
                                         tcfg(cfg), CPU)


def mesh(m):
    return make_mesh(8, model=m, devices=[CPU] * 8)


def jsharded(tree, m):
    return jax.device_put(tree, j_rule(j_mesh(8, model=m), tree))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


# ------------------------------------------------------------ (a) layout


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind", ["plain", "int8", "lora"])
def test_shard_params_places_by_the_rule_and_round_trips(m, kind):
    tree = tparams(kind)
    msh = mesh(m)
    sh = tp.shard_params(msh, tree)
    jspec = dict(leaves(j_rule(j_mesh(8, model=m), jparams(kind))))
    for (name, leaf), (_, s) in zip(leaves(tree), leaves(sh)):
        assert isinstance(s, tp.Sharded) and s.shape == tuple(leaf.shape)
        spec = tuple(jspec[name].spec)
        want = spec.index("model") if "model" in spec else None
        assert s.dim == want, name
        assert s.rows == 8 // m
        for r, row in enumerate(s.shards):
            if s.dim is None:
                assert len(row) == 1 and torch.equal(row[0], leaf)
                assert row[0].device == msh.devices[r, 0]
                continue
            n = leaf.shape[s.dim] // m
            for j, piece in enumerate(row):
                assert piece.device == msh.devices[r, j]
                assert torch.equal(piece, leaf.narrow(s.dim, j * n, n))
    back = tp.gather_params(sh)
    for (name, a), (_, b) in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_rule_at_tinyllama_width_gives_the_documented_table():
    """`parallel/tp.py`'s docstring table, from the rule."""
    L, H, KV, M, V = 22, 2048, 256, 5632, 32000

    def shape(*s):
        return types.SimpleNamespace(shape=s)

    proj = {"wq": (H, H), "wk": (H, KV), "wv": (H, KV), "wo": (H, H),
            "w_gate": (H, M), "w_up": (H, M), "w_down": (M, H)}
    tree = {"tok_emb": {"q": shape(V, H), "s": shape(V)},
            "attn_norm": shape(L, H), "ffn_norm": shape(L, H),
            "final_norm": shape(H),
            "lm_head": {"q": shape(H, V), "s": shape(V)},
            **{k: {"q": shape(L, *io), "s": shape(L, io[1])}
               for k, io in proj.items()}}
    got = param_shardings(make_mesh(2, model=2, devices=[CPU] * 2), tree)
    assert got == {
        "tok_emb": {"q": 0, "s": None}, "attn_norm": 1, "ffn_norm": 1,
        "final_norm": None, "lm_head": {"q": 1, "s": None},
        "wq": {"q": 1, "s": 1}, "wk": {"q": 1, "s": 1},
        "wv": {"q": 1, "s": 1}, "wo": {"q": 1, "s": 1},
        "w_gate": {"q": 2, "s": 1}, "w_up": {"q": 2, "s": 1},
        "w_down": {"q": 1, "s": 1}}


# ------------------------------------------------------------ (b)-(c)


def t_prefill(params, ids, cfg=CFG):
    ck, cv = tdec.init_kv_cache(tcfg(cfg), ids.shape[0], device=CPU)
    with torch.no_grad():
        return tdec.prefill(params, tcfg(cfg), torch.from_numpy(ids),
                            torch.full((ids.shape[0],), ids.shape[1],
                                       dtype=torch.int32), ck, cv)[0].numpy()


@functools.lru_cache(maxsize=None)
def j_prefill(kind, m):
    ids = prompt_ids()

    def run(p):
        ck, cv = jdec.init_kv_cache(CFG, ids.shape[0])
        return jdec.prefill(p, CFG, jnp.asarray(ids),
                            jnp.asarray([ids.shape[1]] * ids.shape[0]),
                            ck, cv)[0]

    return np.asarray(jax.jit(run)(jsharded(jparams(kind), m)))


def prompt_ids(B=3, T=10):
    return np.random.default_rng(6).integers(0, 64, (B, T)).astype(np.int32)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "int8"])
def test_tp_prefill_matches_jax_sharded_and_one_device(m, kind):
    ids = prompt_ids()
    got = t_prefill(tp.shard_params(mesh(m), tparams(kind)), ids)
    np.testing.assert_allclose(got, j_prefill(kind, m), **TOL)
    np.testing.assert_allclose(got, t_prefill(tparams(kind), ids), **TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tp_generate_tokens_equal_jax_sharded(kv_quant):
    cfg = dataclasses.replace(CFG, kv_quant=kv_quant)
    ids = np.random.default_rng(9).integers(1, 64, (3, 10)).astype(np.int32)
    plen = np.asarray([10, 6, 8], np.int32)
    want, _ = jdec.generate(jsharded(jparams("plain"), 2), cfg,
                            jnp.asarray(ids), jnp.asarray(plen), 8, 63, 0,
                            jax.random.PRNGKey(0), 0.0)
    got, n = tdec.generate(tp.shard_params(mesh(2), tparams("plain")),
                           tcfg(cfg), ids, plen, 8, 63, 0)
    assert (got.numpy() == np.asarray(want)).all()
    one, _ = tdec.generate(tparams("plain"), tcfg(cfg), ids, plen, 8, 63, 0)
    assert torch.equal(got, one)


# ------------------------------------------------------------ (d) batcher


def _serve(params, cfg, kw, prompts, news, prefix=None):
    async def go():
        b = ContinuousBatcher(params, cfg, **kw)
        if prefix is not None:
            b.register_prefix(prefix)
        outs = await asyncio.gather(*[b.submit(p, max_new=n)
                                      for p, n in zip(prompts, news)])
        return outs, b.stats(), b.prefix_hits

    return asyncio.run(go())


@pytest.mark.parametrize("case", ["spec_prefix_int8kv", "kernel_branch"])
def test_tp_batcher_token_identical(case, monkeypatch):
    """The batcher over TP params: speculation, a registered prefix and an
    int8 KV cache (the dry run's setting), and the decode-attention
    kernel branch, whose wrapper runs as often as on one device."""
    rng = np.random.default_rng(11)
    if case == "kernel_branch":
        cfg, kind = KCFG, "plain"
        kw = dict(slots=2, prompt_pad=16, horizon=16, chunk=4)
        prefix = None
    else:
        cfg, kind = dataclasses.replace(CFG, kv_quant=True), "plain"
        kw = dict(slots=2, prompt_pad=16, horizon=48, chunk=2, spec_k=2)
        prefix = [5, 9, 17]
    base = tparams(kind, KCFG if case == "kernel_branch" else CFG)
    prompts = [(prefix or []) + list(rng.integers(1, 64, n)) for n in (4, 7, 2)]
    news = [9, 5, 7]
    real = da.decode_attend_int8
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return real(*a)

    monkeypatch.setattr(da, "decode_attend_int8", counted)
    one = _serve(base, tcfg(cfg), kw, prompts, news, prefix)
    n_one, calls[0] = calls[0], 0
    sh = _serve(tp.shard_params(mesh(2), base), tcfg(cfg), kw, prompts,
                news, prefix)
    assert sh == one
    assert calls[0] == n_one
    if case == "kernel_branch":
        assert n_one > 0
    else:
        assert one[2] == 3


def test_local_llm_over_tp_params():
    """`LocalLLM` keeps a sharded tree on its mesh: solo and batched
    greedy ids equal one device's."""
    from rag_application_tpu_torch.llm.local import LocalLLM

    tok = types.SimpleNamespace(sep_id=63, pad_id=0)
    prompt = [3, 14, 15, 9, 2, 6]
    one = LocalLLM(tparams("int8"), tcfg(), tok, device=CPU)
    sh = LocalLLM(tp.shard_params(mesh(4), tparams("int8")), tcfg(), tok,
                  device=CPU)
    assert sh.generate_ids(prompt, max_new=8) == one.generate_ids(
        prompt, max_new=8)
    assert sh.generate_ids(prompt, max_new=8, speculative=True) == \
        one.generate_ids(prompt, max_new=8, speculative=True)
    with pytest.raises(ValueError, match="merge device"):
        LocalLLM(tp.shard_params(mesh(2), tparams("plain")), tcfg(), tok,
                 device=torch.device("meta"))


# ------------------------------------------------------------ (e)-(g) steps


def lm_batch(ragged, B=8, T=16, vocab=32):
    """tests/test_decoder.py's batch; ``ragged`` pads the rows to other
    lengths, so the global masked mean differs from a mean of the data
    rows' means."""
    rng = np.random.default_rng(0)
    lens = np.asarray([16, 3, 9, 16, 5, 12, 2, 16]) if ragged else [T] * B
    return {"ids": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "mask": np.arange(T)[None, :] < np.asarray(lens)[:, None]}


@pytest.mark.parametrize("ragged", [False, True])
def test_dp_tp_lm_step_matches_jax_sharded(ragged):
    cfg = jdec.DecoderConfig(vocab_size=32, hidden=32, num_layers=2,
                             heads=4, kv_heads=2, mlp_dim=64, max_len=32,
                             dtype="float32")
    params = jdec.init_decoder_params(jax.random.PRNGKey(1), cfg)
    batch = lm_batch(ragged)
    jst, jstep, jb = jtrain.shard_lm_train_setup(
        j_mesh(8, model=2), params, cfg, jtrain.make_optimizer(1e-3))
    jst, jm = jstep(jst, {k: jax.device_put(jnp.asarray(v), jb)
                          for k, v in batch.items()})
    msh = mesh(2)
    st, step, bs = ttrain.shard_lm_train_setup(
        msh, state.decoder_params_from_jax(np_tree(params), tcfg(cfg), CPU),
        tcfg(cfg), ttrain.make_optimizer(1e-3))
    assert bs == "data" and tp.is_sharded(st.params)
    st, m = step(st, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    assert tp.replicas_equal(st.params)
    got = tp.gather_params(st.params)
    for k, v in np_tree(jst.params).items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, atol=2e-5,
                                   rtol=2e-5, err_msg=k)


def test_dp_tp_encoder_step_matches_jax_sharded():
    tiny = dict(vocab_size=128, hidden_dim=32, num_layers=2, num_heads=4,
                mlp_dim=64, max_len=16, out_dim=16, dtype="float32")
    js = j_init(JEncoderConfig(**tiny), max_len=16, seed=1)
    cfg = EncoderConfig(**tiny)
    ts = init_encoder(cfg, device=CPU)
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, CPU))
    rng = np.random.default_rng(4)
    lens = rng.integers(3, 17, (2, 16))
    batch = {}
    for i, side in enumerate("ab"):
        batch["ids_" + side] = rng.integers(0, 128, (16, 16)).astype(np.int32)
        batch["mask_" + side] = np.arange(16)[None, :] < lens[i][:, None]
    lr = 1e-3
    jst, jstep, jb = jtrain.shard_train_setup(j_mesh(8, model=2), js,
                                              jtrain.make_optimizer(lr))
    jst, jm = jstep(jst, {k: jax.device_put(jnp.asarray(v), jb)
                          for k, v in batch.items()})
    st, step, _ = ttrain.shard_train_setup(mesh(2), ts,
                                           ttrain.make_optimizer(lr))
    st, m = step(st, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    assert tp.replicas_equal(st.params)
    want = state.encoder_params_from_jax(jax.tree.map(np.asarray,
                                                      jst.params), cfg, CPU)
    got = tp.gather_params(st.params)
    h = tiny["hidden_dim"]
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("qkv_b"):
            assert (g[h:2 * h] - w[h:2 * h]).abs().max() <= 2 * lr, k
            g, w = torch.cat([g[:h], g[2 * h:]]), torch.cat([w[:h],
                                                            w[2 * h:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   err_msg=k)


def test_sharded_lora_step_matches_jax_sharded():
    wrapped = jlora.lora_init(jax.random.PRNGKey(5), jparams("plain"), r=4)
    opt = jtrain.make_optimizer(lr=1e-3)
    batch = {"ids": np.random.default_rng(3).integers(0, 64, (8, 12)).astype(
        np.int32), "mask": np.ones((8, 12), bool)}
    sh_wrapped = jsharded(wrapped, 2)
    sh_ads = jlora.lora_adapters(sh_wrapped)
    jst = jtrain.TrainState(params=sh_ads, opt_state=opt.init(sh_ads),
                            step=jnp.zeros((), jnp.int32))
    jst, jm = jax.jit(jlora.make_lora_train_step(CFG, opt, remat=False))(
        jst, sh_wrapped, {k: jnp.asarray(v) for k, v in batch.items()})
    tw = tp.shard_params(mesh(2), state.decoder_params_from_jax(
        np_tree(wrapped), tcfg(), CPU))
    topt = ttrain.make_optimizer(lr=1e-3)
    step = tlora.make_lora_train_step(tcfg(), topt, remat=False)
    st = ttrain.init_train_state(tlora.lora_adapters(tw), topt)
    st, m = step(st, tw, batch)
    one = ttrain.init_train_state(tlora.lora_adapters(tp.gather_params(tw)),
                                  topt)
    one, m1 = step(one, tp.gather_params(tw), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    assert tp.replicas_equal(st.params)
    got = tp.gather_params(st.params)["wq"]["b"].detach().float().numpy()
    np.testing.assert_allclose(
        got, one.params["wq"]["b"].detach().float().numpy(), atol=1e-5)
    want = np.asarray(jst.params["wq"]["b"], np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=1e-5 + ulp)


def test_lora_init_and_banks_over_a_sharded_tree():
    """`lora_init` shards the factors it draws by the base's rule; banks
    built from sharded adapters equal the gathered ones'."""
    msh = mesh(2)
    sh = tp.shard_params(msh, tparams("plain"))
    w = tlora.lora_init(torch.Generator().manual_seed(0), sh, r=4)
    assert w["wq"]["a"].dim == 1 and w["wq"]["b"].dim == 2
    assert w["wq"]["w"] is sh["wq"]
    ads = tlora.lora_adapters(w)
    banks = tlora.lora_banks([ads])
    want = tlora.lora_banks([tp.gather_params(ads)])
    for t in want:
        for k in ("a", "b"):
            assert torch.equal(banks[t][k], want[t][k])
    ids = prompt_ids()
    np.testing.assert_allclose(t_prefill(w, ids),
                               t_prefill(tp.gather_params(w), ids), **TOL)


# ------------------------------------------------------------ (h)-(i)


def test_dryrun_multichip_on_a_cpu_mesh():
    from rag_application_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, devices=[CPU] * 8)
    assert np.isfinite(out["loss"]) and np.isfinite(out["lm_loss"])


@pytest.mark.parametrize("kind,m", [("plain", 2), ("int8", 4), ("lora", 2)])
def test_no_weight_matrix_leaves_its_shard(kind, m, monkeypatch):
    """Every move of a TP forward (prefill and decode steps of
    `generate`) goes through `tp.move`; none carries a weight matrix's
    shard (its storage, or a layer slice's shape: the test's batch of 3
    keeps activations off those shapes)."""
    sh = tp.shard_params(mesh(m), tparams(kind))
    storages, shapes = set(), set()
    for name, leaf in leaves(sh):
        # weight matrices: not the norms' and biases' stacked vectors, nor
        # any scale "s" (int8 scales, LoRA's)
        vector = (name.split(".")[0] in ("attn_norm", "ffn_norm",
                                         "final_norm", "bq", "bk", "bv")
                  or name.endswith(".s"))
        if leaf.dim is not None and not vector:
            for t in leaf.tensors():
                storages.add(t.untyped_storage().data_ptr())
                shapes.add(tuple(t.shape[-2:]))
    moved = []
    real = tp.move

    def watch(t, device):
        moved.append(t)
        return real(t, device)

    monkeypatch.setattr(tp, "move", watch)
    ids = np.random.default_rng(2).integers(1, 64, (3, 7)).astype(np.int32)
    tdec.generate(sh, tcfg(), ids, np.asarray([7, 5, 6]), 4, 63, 0)
    assert moved
    for t in moved:
        assert t.untyped_storage().data_ptr() not in storages
        assert t.dim() != 2 or tuple(t.shape) not in shapes, t.shape
