"""Grammar-constrained decoding in the port (models/constrain.py, the
decoder's constrained loop, `LocalLLM.chat(response_schema=)`) against
the JAX package's, on the CPU.

- `compile_schema`'s token table and accept vector are byte-equal across
  the packages on every schema and vocabulary of tests/test_constrain.py,
  and the schemas and vocabularies it refuses are refused by both with
  the same message;
- constrained greedy `generate`/`generate_logprobs` on a tiny random
  float32 decoder carried across (`state.decoder_params_from_jax`) emit
  identical tokens, log-probs within rtol 1e-4 / atol 2e-4 (2^-5 with an
  int8 KV cache, as tests/test_torch_decoder.py states);
- `LocalLLM.chat(response_schema=)` returns the same text, constrained or
  prompt-only, and `LLMRouter.generate_structured` the same parsed
  object.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.llm.local import LocalLLM as JLocal
from rag_application_tpu.llm.router import ChatMessage as JChatMessage
from rag_application_tpu.llm.router import LLMRouter as JRouter
from rag_application_tpu.llm.router import Provider as JProvider
from rag_application_tpu.models import constrain as jc
from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models.wordpiece import WordPieceTokenizer as JTok
from rag_application_tpu_torch.llm.local import LocalLLM
from rag_application_tpu_torch.llm.router import ChatMessage, LLMRouter, Provider
from rag_application_tpu_torch.models import constrain as tc
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer
from rag_application_tpu_torch.state import decoder_params_from_jax


class ByteTok:
    """tests/test_constrain.py's toy tokenizer: id i decodes to chr(i)
    for printable ASCII."""

    def decode(self, ids):
        return "".join(chr(i) if 32 <= i < 127 else "\x00" for i in ids)

    def encode(self, text):
        return [ord(c) if 32 <= ord(c) < 127 else 1 for c in text]


class NoBrace(ByteTok):
    """A vocabulary with no '{': refused for any object schema."""

    def decode(self, ids):
        return "".join(chr(i) if 32 <= i < 127 and chr(i) != "{"
                       else "\x00" for i in ids)


class SPLike:
    """The sentencepiece branch: '▁' markers and <0xNN> byte pieces."""
    all_special_ids = [0]

    def convert_ids_to_tokens(self, v):
        table = {0: "<s>", 1: "▁hello", 2: "world", 3: "<0x7B>", 4: "▁",
                 5: "<0x7D>", 6: "<0x22>", 7: "<0x3A>", 8: "true",
                 9: "false", 10: "<0x2C>", 11: "<0x5B>", 12: "<0x5D>"}
        return table.get(v, "x")


def hf_bytelevel():
    """tests/test_constrain.py's in-process byte-level BPE tokenizer."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(b2u.values())}
    merges = [('{', '"'), ('"', ':'), ('t', 'r'), ('tr', 'u'), ('tru', 'e'),
              ('f', 'a'), ('fa', 'l'), ('fal', 's'), ('fals', 'e')]
    for m in ['tr', 'tru', 'fa', 'fal', 'fals', '{"', '":', 'true',
              'false']:
        vocab[m] = len(vocab)
    raw = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    raw.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    raw.decoder = decoders.ByteLevel()
    return PreTrainedTokenizerFast(tokenizer_object=raw), len(vocab)


WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "user", "assistant", ":",
         "emit", "the", "record", "{", "}", "\"", ",", "##{", "##}",
         "##\"", "##:", "##,", "##true", "##false", "##alpha", "##beta",
         "##kind", "##ok", "##1", "##2", "##0"]

SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "minLength": 1, "maxLength": 6},
    "count": {"type": "integer", "minimum": 0, "maximum": 99999},
    "kind": {"enum": ["alpha", "beta"]},
}}
FINITE = {"type": "object", "properties": {
    "kind": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}

SCHEMAS = [
    {"type": "integer"}, {"type": "number"}, {"type": "boolean"},
    {"type": "null"}, {"type": "string"}, {"enum": ["a", "bb"]},
    {"const": {"a": [1, 2]}},
    {"type": "string", "minLength": 2, "maxLength": 4},
    {"type": "integer", "minimum": -5, "maximum": 120},
    {"type": "array", "items": {"type": "integer"}},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 1},
    {"type": "object", "properties": {
        "name": {"type": "string", "maxLength": 8},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"enum": ["x", "y"]}},
        "ok": {"type": "boolean"}}},
    SCHEMA, FINITE,
    {"type": "object", "properties": {
        "ok": {"type": "boolean"},
        "n": {"type": "integer", "minimum": 0, "maximum": 99}}},
    # refused: outside the subset
    {"type": "object"}, {"anyOf": [{"type": "string"}]},
    {"enum": []}, {"enum": [1, 2]},
]


def outcome(fn, *args):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001
        return None, (type(e).__name__, str(e))


def vocabularies():
    """name -> (the reference's tokenizer, the port's, vocab size)."""
    out = {"bytes": (ByteTok(), ByteTok(), 160),
           "nobrace": (NoBrace(), NoBrace(), 160),
           "splike": (SPLike(), SPLike(), 13),
           "wordpiece": (JTok.from_vocab_list(WORDS, native=False),
                         WordPieceTokenizer.from_vocab_list(WORDS,
                                                            native=False),
                         len(WORDS))}
    try:
        hf, v = hf_bytelevel()
        out["hf-bytelevel"] = (hf, hf, v)
    except Exception:  # noqa: BLE001 — tokenizers/transformers missing
        pass
    return out


@pytest.mark.parametrize("si", range(len(SCHEMAS)))
def test_regex_dfa_equal(si):
    """schema -> AST -> byte DFA: the same transitions and accept states,
    or the same refusal."""
    schema = SCHEMAS[si]
    jr, je = outcome(jc.schema_to_regex, schema)
    tr, te = outcome(tc.schema_to_regex, schema)
    assert te == je
    if je is None:
        jt, ja = jc.compile_regex(jr)
        tt, ta = tc.compile_regex(tr)
        assert tt.dtype == jt.dtype and tt.tobytes() == jt.tobytes()
        assert ta.tobytes() == ja.tobytes()


@pytest.mark.parametrize("vi", ["bytes", "nobrace", "splike", "wordpiece",
                                "hf-bytelevel"])
def test_compile_schema_tables_byte_equal(vi):
    vocabs = vocabularies()
    if vi not in vocabs:
        pytest.skip("tokenizers/transformers not installed")
    jtok, tok, v = vocabs[vi]
    jb, jl = jc.token_bytes(jtok, v)
    tb, tl = tc.token_bytes(tok, v)
    assert tb.tobytes() == jb.tobytes() and tl.tobytes() == jl.tobytes()
    refused = 0
    for schema in SCHEMAS:
        j, je = outcome(jc.compile_schema, schema, jtok, v)
        t, te = outcome(tc.compile_schema, schema, tok, v)
        assert te == je, schema
        if je is not None:
            refused += 1
            continue
        assert t.table.dtype == j.table.dtype == np.int32
        assert t.table.tobytes() == j.table.tobytes()
        assert t.accept.tobytes() == j.accept.tobytes()
        dev = t.as_device("cpu")
        assert dev["table"].dtype == torch.int32
        assert np.array_equal(dev["table"].numpy(), j.table)
        assert np.array_equal(dev["accept"].numpy(), j.accept)
    assert refused >= 4  # the four unsupported schemas at least
    if vi == "nobrace":
        with pytest.raises(ValueError, match="cannot realize"):
            tc.compile_schema(SCHEMA, tok, v)


def test_stack_constraints_equal():
    tok = ByteTok()
    js = [jc.compile_schema(s, tok, 160) for s in (SCHEMA, FINITE)]
    ts = [tc.compile_schema(s, tok, 160) for s in (SCHEMA, FINITE)]
    j = jc.stack_constraints([js[0], None, js[1]], 160, n_banks=4,
                             min_states=8)
    t = tc.stack_constraints([ts[0], None, ts[1]], 160, n_banks=4,
                             min_states=8)
    assert t.table.tobytes() == j.table.tobytes()
    assert t.accept.tobytes() == j.accept.tobytes()


# --------------------------------------------------------- constrained decode

TINY = jdec.DecoderConfig(vocab_size=160, hidden=32, num_layers=2, heads=4,
                          kv_heads=2, mlp_dim=64, max_len=512,
                          dtype="float32")
# the main-path flags: int8 weights, int8 KV and the decode kernel branch
KERNEL = dataclasses.replace(TINY, hidden=256, kv_quant=True,
                             attn_kernel=True)
EOS = 158  # outside the grammar: only the accept-state mask allows it


def _tree(params):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}


def _params(cfg, seed, quant=False):
    params = jdec.init_decoder_params(jax.random.PRNGKey(seed), cfg)
    if quant:
        params = jdec.quantize_decoder_params(params)
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    return params, decoder_params_from_jax(_tree(params), tcfg, "cpu"), tcfg


def _tol(cfg):
    return dict(rtol=1e-4, atol=2.0 ** -5 if cfg.kv_quant else 2e-4)


@pytest.mark.parametrize("kind", ["tiny", "kernel"])
@pytest.mark.parametrize("schema", [SCHEMA, FINITE],
                         ids=["free-string", "finite"])
def test_constrained_greedy_generate_identical(kind, schema):
    cfg, quant = (TINY, False) if kind == "tiny" else (KERNEL, True)
    jp, tp, tcfg = _params(cfg, 5, quant)
    jcon = jc.compile_schema(schema, ByteTok(), 160).as_device()
    tcon = tc.compile_schema(schema, ByteTok(), 160).as_device("cpu")
    ids = np.asarray([[70, 71, 72, 0], [65, 66, 67, 68]], np.int32)
    plen = np.asarray([3, 4], np.int32)
    jo, jn, jl = jdec.generate_logprobs(
        jp, cfg, jnp.asarray(ids), jnp.asarray(plen), 100, EOS, 0,
        jax.random.PRNGKey(0), 0.0, 32, 1.0, None, 0.0, 0.0, jcon)
    to, tn, tl = tdec.generate_logprobs(
        tp, tcfg, ids, plen, 100, EOS, 0, None, 0.0, 32, 1.0, None, 0.0,
        0.0, tcon)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_tol(cfg))
    for row in to.numpy():
        text = ByteTok().decode([int(t) for t in row if int(t) not in
                                 (0, EOS)])
        assert set(json.loads(text)) == set(schema["properties"])
    # generate() is generate_logprobs' tokens
    to2, _ = tdec.generate(tp, tcfg, ids, plen, 100, EOS, 0, None, 0.0, 32,
                           1.0, None, 0.0, 0.0, tcon)
    assert np.array_equal(to2.numpy(), to.numpy())


def test_sampled_constrained_output_is_valid():
    """tests/test_constrain.py's flagship property on the port: a random
    decoder sampled at temperature 1 emits schema-valid JSON on every
    seed (the port's random stream differs from the reference's, so the
    law is held, not the tokens)."""
    _, tp, tcfg = _params(TINY, 0)
    con = tc.compile_schema(SCHEMA, ByteTok(), 160).as_device("cpu")
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        out, _ = tdec.generate(tp, tcfg, np.asarray([[65, 66, 67, 68]]),
                               np.asarray([4]), 120, EOS, 0, gen, 1.0, 32,
                               0.95, None, 0.0, 0.0, con)
        doc = json.loads(ByteTok().decode(
            [int(t) for t in out[0] if int(t) not in (0, EOS)]))
        assert set(doc) == {"name", "count", "kind"}
        assert 1 <= len(doc["name"]) <= 6 and doc["kind"] in ("alpha",
                                                              "beta")


def _locals(seed=1):
    jp, tp, tcfg = _params(TINY, seed)
    return (JLocal(jp, TINY, ByteTok(), eos_id=EOS),
            LocalLLM(tp, tcfg, ByteTok(), eos_id=EOS, device="cpu"))


@pytest.mark.parametrize("schema", [SCHEMA, FINITE, {"anyOf": [{}]}],
                         ids=["free-string", "finite", "refused"])
def test_local_chat_response_schema_text_equal(schema):
    j, t = _locals()
    kw = dict(response_schema=schema, max_tokens=100)
    jr = asyncio.run(j.chat([JChatMessage("user", "emit the record")], **kw))
    tr = asyncio.run(t.chat([ChatMessage("user", "emit the record")], **kw))
    assert tr.content == jr.content and tr.usage == jr.usage
    key = t._schema_key(schema)
    compiled = t._constraint_cache[key] is not None
    assert compiled == (j._constraint_cache[key] is not None)
    assert compiled == ("anyOf" not in schema)
    if compiled:
        assert set(json.loads(tr.content)) == set(schema["properties"])
        dev = t._constraint_dev[key]
        assert dev["table"].device.type == "cpu"


def test_generate_structured_equal():
    j, t = _locals(3)
    jr = JRouter(JProvider.LOCAL, local=j)
    tr = LLMRouter(Provider.LOCAL, local=t)
    for schema in (SCHEMA, FINITE):
        want = asyncio.run(jr.generate_structured("emit the record", schema,
                                                  max_tokens=100))
        got = asyncio.run(tr.generate_structured("emit the record", schema,
                                                 max_tokens=100))
        assert got == want and set(got) == set(schema["properties"])
