"""Parity of the port's `LocalLLM` (llm/local.py) and its router path with
the JAX package's, on the same WordPiece tokenizer and carried weights.

Greedy decoding in float32 configs: token ids, chat texts and streamed
texts are identical; choice scores and log-probs agree to rtol 1e-4 /
atol 2e-4, and to 2^-5 absolute with an int8 KV cache
(tests/test_torch_decoder.py states why).
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest

from rag_application_tpu.llm.local import LocalLLM as JLocal
from rag_application_tpu.llm.router import LLMRouter as JRouter
from rag_application_tpu.llm.router import Provider as JProvider
from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models.wordpiece import WordPieceTokenizer as JTok
from rag_application_tpu_torch.llm.local import LocalLLM
from rag_application_tpu_torch.llm.router import ChatMessage, LLMRouter, Provider
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer
from rag_application_tpu_torch.state import decoder_params_from_jax

WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "system", "user",
         "assistant", ":", "you", "are", "helpful", "hello", "world",
         "how", "is", "the", "weather", "today", "##s", "##ing", "a",
         "answer", "question", "toky", "##o", "fine", "sunny"]
TINY = jdec.DecoderConfig(vocab_size=len(WORDS), hidden=32, num_layers=2,
                          heads=4, kv_heads=2, mlp_dim=64, max_len=48,
                          dtype="float32")
# the main-path flags: int8 weights, int8 KV and the decode kernel branch
KERNEL = dataclasses.replace(TINY, hidden=256, max_len=64, kv_quant=True,
                             attn_kernel=True)
MSGS = [ChatMessage("system", "you are helpful"),
        ChatMessage("user", "hello how is the weather")]


def _tol(cfg):
    return dict(rtol=1e-4, atol=2.0 ** -5 if cfg.kv_quant else 2e-4)


def _pair(cfg, quant=False):
    params = jdec.init_decoder_params(jax.random.PRNGKey(7), cfg)
    if quant:
        params = jdec.quantize_decoder_params(params)
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in params.items()}
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    j = JLocal(params, cfg, JTok.from_vocab_list(WORDS, native=False),
               model_name="tiny-local")
    t = LocalLLM(decoder_params_from_jax(tree, tcfg, "cpu"), tcfg,
                 WordPieceTokenizer.from_vocab_list(WORDS, native=False),
                 model_name="tiny-local", device="cpu")
    return j, t


@pytest.fixture(scope="module", params=["tiny", "kernel"])
def pair(request):
    return _pair(TINY) if request.param == "tiny" else _pair(KERNEL, True)


async def _collect(gen):
    return [c async for c in gen]


def test_generate_ids_identical(pair):
    j, t = pair
    prompt = j.render(MSGS)
    assert t.render(MSGS) == prompt
    assert t.generate_ids(prompt, max_new=12) == j.generate_ids(prompt,
                                                                max_new=12)
    tj, lj = j.generate_ids_logprobs(prompt, max_new=6)
    tt, lt = t.generate_ids_logprobs(prompt, max_new=6)
    assert tt == tj
    np.testing.assert_allclose(lt, lj, **_tol(t.cfg))


def test_chat_stream_and_router_identical(pair):
    j, t = pair
    jr = JRouter(JProvider.LOCAL, model="tiny-local", local=j)
    tr = LLMRouter(Provider.LOCAL, model="tiny-local", local=t)

    async def drive(router):
        resp = await router.chat(MSGS, max_tokens=10, temperature=0.0)
        chunks = await _collect(router.stream(MSGS, max_tokens=10,
                                              temperature=0.0))
        return resp, chunks

    (rj, cj), (rt, ct) = asyncio.run(drive(jr)), asyncio.run(drive(tr))
    assert rt.content == rj.content and rt.usage == rj.usage
    assert "".join(ct) == rt.content and ct == cj
    # stop truncates the chat text and the stream alike
    words = rt.content.split()
    if len(words) > 1:
        stop = words[1]
        sj = asyncio.run(j.chat(MSGS, max_tokens=10, stop=stop)).content
        st = asyncio.run(t.chat(MSGS, max_tokens=10, stop=stop)).content
        cs = asyncio.run(_collect(t.stream(MSGS, max_tokens=10, stop=stop)))
        assert st == sj == LocalLLM._apply_stop(rt.content, stop)
        assert "".join(cs) == st


def test_penalized_stream_and_choice(pair):
    j, t = pair
    kw = dict(max_tokens=8, presence_penalty=0.8, frequency_penalty=0.5,
              logit_bias={"12": 3.0})
    cj = asyncio.run(_collect(j.stream(MSGS, **kw)))
    ct = asyncio.run(_collect(t.stream(MSGS, **kw)))
    assert ct == cj
    assert "".join(ct) == asyncio.run(t.chat(MSGS, **kw)).content
    options = ["sunny", "fine today", "hello world"]
    assert t.choose_text(MSGS, options) == j.choose_text(MSGS, options)
    prompt = t.render(MSGS)
    enc = [t.tokenizer.encode(o)[:-1] for o in options]
    (ij, sj), (it, st) = j.choose(prompt, enc), t.choose(prompt, enc)
    assert it == ij
    np.testing.assert_allclose(st, sj, **_tol(t.cfg))


def test_generate_ids_cache_geometry(pair, monkeypatch):
    """The prompt pads to a power-of-two bucket; the cache holds bucket +
    max_new slots, rounded up to 256 when the kernel cannot tile that,
    and at B 1 the kernel branch takes that S."""
    _, t = pair
    lengths, shapes = [], []
    real_init, real_attn = tdec.init_kv_cache, tdec._da.decode_attend_int8

    def init(cfg, batch, length=None, device=None):
        lengths.append(length)
        return real_init(cfg, batch, length, device)

    def attn(qg, ck, cv, mask):
        shapes.append(tuple(ck["q"].shape))
        return real_attn(qg, ck, cv, mask)

    monkeypatch.setattr(tdec, "init_kv_cache", init)
    monkeypatch.setattr(tdec._da, "decode_attend_int8", attn)
    prompt = t.render(MSGS)  # 15 tokens -> bucket 16
    assert len(prompt) == 15
    t.generate_ids(prompt, max_new=9)
    want = 16 + 9
    if t.cfg.attn_kernel:
        want = 256  # pick_block(25) is None
        assert shapes and set(shapes) == {(1, 256, t.cfg.kv_heads,
                                           t.cfg.head_dim)}
    else:
        assert not shapes
    assert lengths == [want]


def test_unported_paths_raise():
    _, t = _pair(TINY)
    prompt = t.render(MSGS)
    with pytest.raises(NotImplementedError):
        t.generate_ids(prompt, speculative=True)
    for call in (lambda: t.enable_batching(),
                 lambda: t.register_lora("a", {}),
                 lambda: LocalLLM.from_hf_dir("model_dir"),
                 lambda: asyncio.run(t.chat(MSGS, response_schema={
                     "type": "object"}))):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError):
        asyncio.run(t.chat(MSGS, adapter="none-registered"))
