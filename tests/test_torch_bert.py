"""The port's HF loaders: `models/bert.py` against the JAX package's flax
`BertEncoder` and `transformers.BertModel`, case for case with
tests/test_bert_import.py, and `LocalLLM.from_hf_dir` against the JAX
package's on a tiny LLaMA checkpoint written to a temporary directory
(no download).

Tolerances: the pooled embeddings and token states of float32 models are
held to rtol 1e-3 / atol 1e-4 against `BertModel` (the reference's own
bound) and to 1e-5 absolute against the flax encoder on the same
weights. Greedy chats through `from_hf_dir` give identical texts.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.models import bert as jbert
from rag_application_tpu_torch.models import bert as tbert
from rag_application_tpu_torch.state import bert_params_from_jax

CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=48, type_vocab_size=2,
           layer_norm_eps=1e-12)


@pytest.fixture(scope="module")
def torch_bert():
    transformers = pytest.importorskip("transformers")
    config = transformers.BertConfig(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **CFG)
    torch.manual_seed(0)
    model = transformers.BertModel(config)
    model.eval()
    return model


def _inputs(seed, B, L, ragged=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (B, L)).astype(np.int64)
    mask = np.ones((B, L), dtype=np.int64)
    if ragged:
        mask[1, 10:] = 0
    return ids, mask


def _port(model, ids, mask, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask).bool(),
                     **kw)


def _flax(state, ids, mask, **kw):
    model, params = jbert.load_hf_encoder(state, config=CFG)
    return model.apply(params, jnp.asarray(ids.astype(np.int32)),
                       jnp.asarray(mask.astype(bool)), **kw)


def test_flax_matches_torch_bert(torch_bert):
    """Same random weights -> the same mean-pooled embeddings as
    `BertModel` and as the flax encoder."""
    ids, mask = _inputs(0, 3, 16)
    with torch.no_grad():
        h = torch_bert(input_ids=torch.tensor(ids),
                       attention_mask=torch.tensor(mask)
                       ).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    ref = (h * m).sum(1) / m.sum(1)
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)

    model, _ = tbert.load_hf_encoder(torch_bert.state_dict(), config=CFG,
                                     device="cpu")
    got = _port(model, ids, mask).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(_flax(torch_bert.state_dict(), ids, mask)),
        rtol=0, atol=1e-5)


def test_token_outputs_match(torch_bert):
    ids, mask = _inputs(1, 2, 12, ragged=False)
    with torch.no_grad():
        ref = torch_bert(input_ids=torch.tensor(ids),
                         attention_mask=torch.tensor(mask)
                         ).last_hidden_state.numpy()
    model, _ = tbert.load_hf_encoder(torch_bert.state_dict(), config=CFG,
                                     device="cpu")
    _, tokens = _port(model, ids, mask, return_tokens=True)
    np.testing.assert_allclose(tokens.numpy(), ref, rtol=1e-3, atol=1e-4)
    _, jtok = _flax(torch_bert.state_dict(), ids, mask, return_tokens=True)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtok), rtol=0,
                               atol=1e-5)


def test_convert_rejects_missing_keys():
    with pytest.raises(KeyError):
        tbert.convert_hf_state_dict({}, hidden=32, heads=4, num_layers=1)


def test_flax_params_carried():
    """A flax `BertEncoder` initialized at random, its parameters carried
    by `state.bert_params_from_jax`: pooled and token outputs within
    1e-5 of the flax forward, on ragged masks."""
    import jax

    model = jbert.BertEncoder(vocab_size=128, hidden=32, num_layers=2,
                              heads=4, mlp_dim=64, max_len=48)
    ids, mask = _inputs(2, 3, 16)
    params = model.init(jax.random.PRNGKey(5),
                        jnp.asarray(ids.astype(np.int32)),
                        jnp.asarray(mask.astype(bool)))
    # LayerNorm and biases leave init at 1 / 0: perturb every leaf so
    # each one's mapping is exercised
    leaves, tree = jax.tree.flatten(params)
    r = np.random.default_rng(3)
    params = jax.tree.unflatten(tree, [
        np.asarray(x) + 0.05 * r.standard_normal(x.shape).astype(np.float32)
        for x in leaves])
    port = tbert.BertEncoder(vocab_size=128, hidden=32, num_layers=2,
                             heads=4, mlp_dim=64, max_len=48)
    port.load_state_dict(bert_params_from_jax(params, device="cpu"))
    port.eval()
    jp, jt = model.apply(params, jnp.asarray(ids.astype(np.int32)),
                         jnp.asarray(mask.astype(bool)), return_tokens=True)
    tp, tt = _port(port, ids, mask, return_tokens=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)


@pytest.mark.parametrize("safe", [True, False],
                         ids=["safetensors", "torch-bin"])
def test_load_hf_encoder_from_dir(torch_bert, tmp_path, safe):
    """A checkpoint directory (`model.safetensors`, or
    `pytorch_model.bin`) loads to the same encoder as the state dict."""
    torch_bert.save_pretrained(tmp_path, safe_serialization=safe)
    model, state = tbert.load_hf_encoder(str(tmp_path), device="cpu")
    ids, mask = _inputs(4, 2, 10)
    want, _ = tbert.load_hf_encoder(torch_bert.state_dict(), config=CFG,
                                    device="cpu")
    assert torch.equal(_port(model, ids, mask), _port(want, ids, mask))
    assert set(state) == set(want.state_dict())


VOCAB = ["<pad>", "<unk>", "</s>", "user", "assistant", ":", "hello",
         "world", "how", "is", "the", "weather", "today", "fine", "sunny",
         "a", "question", "answer"]


def _llama_dir(path, rope_scaling=None):
    """A tiny random LlamaForCausalLM and a word-level fast tokenizer,
    saved as a HF checkpoint directory."""
    transformers = pytest.importorskip("transformers")
    tokenizers = pytest.importorskip("tokenizers")
    tk = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(VOCAB)}, unk_token="<unk>"))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.WhitespaceSplit()
    tk.decoder = tokenizers.decoders.WordPiece(prefix="##")
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>", eos_token="</s>",
        pad_token="<pad>")
    cfg = transformers.LlamaConfig(
        vocab_size=len(VOCAB), hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_scaling=rope_scaling,
        eos_token_id=2, bos_token_id=None, pad_token_id=0)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(path)
    fast.save_pretrained(path)
    return str(path)


@pytest.mark.parametrize("kind", ["plain", "int8", "llama3"])
def test_from_hf_dir_matches_jax(tmp_path, kind):
    """`LocalLLM.from_hf_dir` on the same directory: the JAX package's
    config and greedy chat text (float32; `quantize` + `kv_quant`; a
    llama3 rope scaling)."""
    from rag_application_tpu.llm.local import LocalLLM as JLocal
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage

    rope = ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
             "high_freq_factor": 4.0,
             "original_max_position_embeddings": 32}
            if kind == "llama3" else None)
    d = _llama_dir(tmp_path, rope)
    kw = dict(dtype="float32", max_len=64)
    if kind == "int8":
        kw.update(quantize=True, kv_quant=True)
    t = LocalLLM.from_hf_dir(d, device="cpu", **kw)
    j = JLocal.from_hf_dir(d, **kw)
    # the reference's fields equal; the port's latent-attention and expert
    # fields (DeepSeek-V2, which the reference lacks) stay off
    assert {k: vars(t.cfg)[k] for k in vars(j.cfg)} == vars(j.cfg)
    assert not t.cfg.latent and t.cfg.n_routed_experts == 0
    assert t.eos_id == j.eos_id == 2
    msgs = [ChatMessage("user", "hello how is the weather today")]

    async def chat(m):
        return (await m.chat(msgs, max_tokens=12)).content

    got, want = asyncio.run(chat(t)), asyncio.run(chat(j))
    assert got == want and got


@pytest.mark.parametrize("kind", ["plain", "int8"])
def test_from_hf_dir_lora_path_raises(tmp_path, kind):
    """`from_hf_dir(lora_path=)` (which raised before models/lora.py was
    ported) merges an adapter npz written by the JAX `save_adapters`
    into the weights before quantization: chat texts equal the JAX
    `from_hf_dir` with the same file (one target without a stored scale,
    so `lora_alpha` applies to it), and differ from the base's."""
    import jax
    import jax.numpy as jnp

    from rag_application_tpu.llm.local import LocalLLM as JLocal
    from rag_application_tpu.models.lora import save_adapters
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage

    d = _llama_dir(tmp_path / "model")
    key = jax.random.PRNGKey(4)
    ads, wrapped = {}, {}
    for t, fin, fout in (("wq", 64, 64), ("wv", 64, 32), ("wo", 64, 64)):
        key, k1, k2 = jax.random.split(key, 3)
        ads[t] = {"a": jax.random.normal(k1, (2, fin, 4)) * 0.5,
                  "b": jax.random.normal(k2, (2, 4, fout)) * 0.5}
        if t != "wo":
            wrapped[t] = {"s": jnp.full((2, 1, 1), 3.0, jnp.float32)}
    npz = str(tmp_path / "adapters.npz")
    save_adapters(ads, npz, wrapped=wrapped)
    kw = dict(dtype="float32", max_len=64)
    if kind == "int8":
        kw.update(quantize=True, kv_quant=True)
    msgs = [ChatMessage("user", "hello how is the weather today")]

    async def chat(m):
        return (await m.chat(msgs, max_tokens=12)).content

    t = LocalLLM.from_hf_dir(d, device="cpu", lora_path=npz, lora_alpha=8.0,
                             **kw)
    j = JLocal.from_hf_dir(d, lora_path=npz, lora_alpha=8.0, **kw)
    base = LocalLLM.from_hf_dir(d, device="cpu", **kw)
    assert isinstance(t.params["wq"], dict) == (kind == "int8")
    got, want = asyncio.run(chat(t)), asyncio.run(chat(j))
    assert got == want and got
    assert got != asyncio.run(chat(base))
