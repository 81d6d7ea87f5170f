"""Helpers for the port's parity tests: encoders with the same weights in
both packages, and the reference's dense tables carried into the port's
stores (`state.dense_from_numpy`), so that searches compare the same
tables (tests/test_torch_prep.py bounds the insert-time differences)."""

import jax
import numpy as np

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.kg.store import Space as JSpace
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import EncoderConfig
from rag_application_tpu_torch.kg.store import Space
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.encoder import init_encoder


def embedder_pair(ecfg, *, seed, max_len=16, batch_size=4,
                  multimodal=False):
    """(JAX Embedder, port Embedder on the CPU) with the same weights, on
    the text tower or, with ``multimodal``, the multimodal one."""
    js = j_init(JEncoderConfig(**ecfg), max_len=max_len, seed=seed,
                multimodal=multimodal)
    cfg = EncoderConfig(**ecfg)
    ts = init_encoder(cfg, device="cpu", multimodal=multimodal)
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return (JEmbedder(js, batch_size=batch_size, max_len=max_len),
            Embedder(ts, batch_size=batch_size, max_len=max_len))


def dense_arrays(j):
    """A JAX DenseIndex's tables as numpy (bf16 planes as uint16 bits)."""
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": (None if j.vecs is None
                     else np.asarray(j.vecs).view(np.uint16)),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def carried(j, cfg):
    """The port's DenseIndex holding a JAX DenseIndex's tables."""
    return state.dense_from_numpy(cfg, dense_arrays(j), j.size,
                                  j.has_deletes, device="cpu")


def carry_collection(jcol, tcol):
    """Put the reference collection's dense tables into the port's."""
    tcol.dense = carried(jcol.dense, tcol.cfg.index)
    tcol._fused.dense = tcol.dense


def carry_kg(jkg, tkg):
    """Put the reference KG's space indexes into the port's."""
    for s in Space:
        j = jkg.spaces[JSpace(s.value)].index
        tkg.spaces[s].index = carried(j, tkg.spaces[s].index.cfg)


def jax_embedder_from_port(temb, ecfg, *, max_len, batch_size=4):
    """A JAX Embedder holding a port Embedder's weights (the inverse of
    `state.encoder_params_from_jax`), for comparing against a port
    process whose encoder was initialised by the port."""
    import jax.numpy as jnp

    from rag_application_tpu.models.encoder import EncoderState

    js = j_init(JEncoderConfig(**ecfg), max_len=max_len)
    sd = {k: v.detach().cpu().numpy()
          for k, v in temb.state.model.state_dict().items()}
    h, heads = ecfg["hidden_dim"], ecfg["num_heads"]
    hd = h // heads
    p = {"token_embed": {"embedding": sd["token_embed"]},
         "pos_embed": {"embedding": sd["pos_embed"]},
         "final_ln": {"scale": sd["final_ln_scale"],
                      "bias": sd["final_ln_bias"]},
         "proj": {"kernel": sd["proj_w"], "bias": sd["proj_b"]}}
    for i in range(ecfg["num_layers"]):
        pre = f"layers.{i}."
        qkv_w = sd[pre + "qkv_w"].reshape(h, 3, heads, hd)
        qkv_b = sd[pre + "qkv_b"].reshape(3, heads, hd)
        att = {n: {"kernel": qkv_w[:, j], "bias": qkv_b[j]}
               for j, n in enumerate(("query", "key", "value"))}
        att["out"] = {"kernel": sd[pre + "out_w"].reshape(heads, hd, h),
                      "bias": sd[pre + "out_b"]}
        p[f"layer_{i}"] = {
            "LayerNorm_0": {"scale": sd[pre + "ln1_scale"],
                            "bias": sd[pre + "ln1_bias"]},
            "LayerNorm_1": {"scale": sd[pre + "ln2_scale"],
                            "bias": sd[pre + "ln2_bias"]},
            "MultiHeadDotProductAttention_0": att,
            "Dense_0": {"kernel": sd[pre + "mlp1_w"],
                        "bias": sd[pre + "mlp1_b"]},
            "Dense_1": {"kernel": sd[pre + "mlp2_w"],
                        "bias": sd[pre + "mlp2_b"]}}
    want = jax.tree.structure(js.params)
    params = jax.tree.map(jnp.asarray, {"params": p})
    assert jax.tree.structure(params) == want
    return JEmbedder(EncoderState(model=js.model, params=params, cfg=js.cfg),
                     batch_size=batch_size, max_len=max_len)
