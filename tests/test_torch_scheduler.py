"""Parity of the port's continuous batcher (`llm/scheduler.py`) with the
JAX package's, case for case with tests/test_scheduler.py, on the JAX
decoder weights carried across by `state.decoder_params_from_jax`.

Greedy tokens through the port's batcher must equal the JAX package's
solo `generate` (which its own tests hold equal to the JAX batcher)
across joins, compaction, eos, int8 caches, the decode-attention kernel
branch, prefix-cached admission, speculation and lookahead; where the
schedule is deterministic the JAX batcher runs too and the counters
(`stats()`, prefix hits, speculative and plain dispatches) must be
equal. Sampled batchers draw from `torch.Generator`s, not `jax.random`:
they are held to their seed, to validity and, for the first token, to
the filtered law by Monte Carlo. Multi-LoRA rows (banks built by the
port's `lora_banks`, held bit-equal to the reference's) must give the
tokens of the JAX solo `generate` with their adapter merged. Over
parameters sharded by `parallel/tp.py::shard_params` the same batcher
gives the same tokens (tests/test_torch_tp.py holds the sharded
decoder to the JAX package's sharded one).
"""

import asyncio
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.llm.scheduler import ContinuousBatcher as JBatcher
from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models import lora as jlora
from rag_application_tpu_torch import state
from rag_application_tpu_torch.llm import scheduler as tsch
from rag_application_tpu_torch.llm.scheduler import DEAD, ContinuousBatcher
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models import lora as tlora
from rag_application_tpu_torch.state import decoder_params_from_jax

CFG = jdec.DecoderConfig(vocab_size=256, hidden=64, num_layers=3, heads=4,
                         kv_heads=2, mlp_dim=128, max_len=128,
                         dtype="float32")
QCFG = dataclasses.replace(CFG, kv_quant=True)
# the decode-attention kernel branch: kv_heads * head_dim % 128 == 0 and a
# slot axis that a kernel block tiles (prompt_pad + horizon = 32 below)
KCFG = dataclasses.replace(CFG, hidden=256, kv_quant=True, attn_kernel=True)
PARAMS = {c: jdec.init_decoder_params(jax.random.PRNGKey(0), c)
          for c in (CFG, KCFG)}
PARAMS[QCFG] = PARAMS[CFG]


def tcfg(cfg):
    return tdec.DecoderConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def tparams(cfg):
    tree = {k: np.asarray(v) for k, v in PARAMS[cfg].items()}
    return decoder_params_from_jax(tree, tcfg(cfg), "cpu")


def batcher(cfg=CFG, **kw):
    return ContinuousBatcher(tparams(cfg), tcfg(cfg), **kw)


@functools.lru_cache(maxsize=None)
def _solo_cached(prompt, max_new, prompt_pad, eos_id, cfg):
    ids = np.zeros((1, prompt_pad), np.int32)
    ids[0, :len(prompt)] = prompt
    out, _ = jdec.generate(PARAMS[cfg], cfg, ids,
                           np.asarray([len(prompt)], np.int32), max_new,
                           eos_id, -7, jax.random.PRNGKey(0), 0.0)
    return [int(t) for t in np.asarray(out)[0] if int(t) not in (-7, eos_id)]


def _solo(prompt, max_new, prompt_pad, eos_id=-1, cfg=CFG):
    """Reference: one JAX greedy `generate` run, eos/pad stripped."""
    return _solo_cached(tuple(int(t) for t in prompt), max_new, prompt_pad,
                        eos_id, cfg)


def _prompts(n, rng):
    return [list(rng.integers(1, CFG.vocab_size, rng.integers(3, 12)))
            for _ in range(n)]


# the counters both batchers keep (the port's `stats()` adds admissions
# and prefix reuse, held in tests/test_torch_tracing.py)
SHARED_STATS = ("steps", "compactions", "tokens_out", "tokens_per_step")


def _counters(b):
    stats = {k: b.stats()[k] for k in SHARED_STATS}
    return (stats, b.prefix_hits, b.spec_dispatches, b.plain_dispatches)


def run_both(kw, jobs, cfg=CFG, prefix=None):
    """The same submissions through a port and a JAX batcher built with
    `kw`: (port outputs, JAX outputs, port counters, JAX counters)."""
    async def go(b):
        if prefix is not None:
            b.register_prefix(prefix)
        outs = await asyncio.gather(*[b.submit(p, **k) for p, k in jobs])
        return outs, _counters(b)

    got, tc = asyncio.run(go(batcher(cfg, **kw)))
    want, jc = asyncio.run(go(JBatcher(PARAMS[cfg], cfg, **kw)))
    return got, want, tc, jc


def test_concurrent_greedy_matches_solo():
    """Four requests in one shared batch: exactly each one's solo tokens,
    and the JAX batcher's counters."""
    rng = np.random.default_rng(0)
    prompts = _prompts(4, rng)
    news = [10, 7, 13, 4]
    got, want, tc, jc = run_both(
        dict(slots=4, prompt_pad=16, horizon=32, chunk=4),
        [(p, dict(max_new=n)) for p, n in zip(prompts, news)])
    assert got == want and tc == jc
    for p, n, toks in zip(prompts, news, got):
        assert toks == _solo(p, n, 16), (p, n)


def test_staggered_joins_keep_rows_independent():
    rng = np.random.default_rng(1)
    prompts = _prompts(6, rng)

    async def run():
        b = batcher(slots=2, prompt_pad=16, horizon=48, chunk=2)

        async def late(i, delay):
            await asyncio.sleep(delay)
            return await b.submit(prompts[i], max_new=6)

        out = await asyncio.gather(*[late(i, 0.02 * i) for i in range(6)])
        assert b.steps > 0
        return out

    got = asyncio.run(run())
    for p, toks in zip(prompts, got):
        assert toks == _solo(p, 6, 16), p


def test_eos_stops_early():
    rng = np.random.default_rng(2)
    prompt = _prompts(1, rng)[0]
    ref = _solo(prompt, 12, 16)
    eos = ref[5]
    want = ref[:ref.index(eos)]

    async def run():
        b = batcher(slots=2, prompt_pad=16, horizon=32, chunk=4)
        return await b.submit(prompt, max_new=12, eos_id=eos)

    assert asyncio.run(run()) == want


def test_compaction_preserves_decode():
    rng = np.random.default_rng(3)
    prompts = _prompts(3, rng)
    got, want, tc, jc = run_both(
        dict(slots=2, prompt_pad=8, horizon=16, chunk=4),
        [(p[:6], dict(max_new=14)) for p in prompts])
    assert tc[0]["compactions"] > 0 and tc == jc and got == want
    for p, toks in zip(prompts, got):
        assert toks == _solo(p[:6], 14, 8), p


def test_cache_overflow_raises_to_submitter():
    rng = np.random.default_rng(4)
    prompt = _prompts(1, rng)[0][:4]

    async def run():
        b = batcher(slots=1, prompt_pad=8, horizon=8, chunk=4)
        await b.submit(prompt, max_new=40)

    with pytest.raises(RuntimeError, match="cache full"):
        asyncio.run(run())


def test_retire_clears_slot_map():
    rng = np.random.default_rng(5)
    prompt = _prompts(1, rng)[0]

    async def run():
        b = batcher(slots=2, prompt_pad=16, horizon=32, chunk=4)
        await b.submit(prompt, max_new=8)
        return b.slot_pos.numpy()

    assert (asyncio.run(run()) == DEAD).all()


@pytest.mark.parametrize("kernel", [False, True], ids=["einsum", "kernel"])
def test_kv_quant_batcher_matches_solo_across_compaction(kernel,
                                                         monkeypatch):
    """int8 KV cache through the batcher, across a forced compaction
    (both leaves of the cache re-packed together): the JAX solo tokens.
    With `attn_kernel`, every decode step's attention goes through the
    kernel wrapper, once per layer per step."""
    cfg = KCFG if kernel else QCFG
    pad, horizon = (16, 16) if kernel else (8, 16)
    calls = []
    real = tdec._da.decode_attend_int8

    def counted(qg, ck, cv, mask):
        calls.append((tuple(ck["q"].shape), int((~mask).all(1).sum())))
        return real(qg, ck, cv, mask)

    monkeypatch.setattr(tdec._da, "decode_attend_int8", counted)
    rng = np.random.default_rng(11)
    prompts = _prompts(3, rng)

    async def run():
        b = batcher(cfg, slots=2, prompt_pad=pad, horizon=horizon, chunk=4)
        assert b.ck["q"].dtype == torch.int8
        outs = await asyncio.gather(*[
            b.submit(p[:6], max_new=14) for p in prompts])
        return outs, b

    got, b = asyncio.run(run())
    assert b.compactions > 0
    for p, toks in zip(prompts, got):
        assert toks == _solo(p[:6], 14, pad, cfg=cfg), p
    if kernel:
        assert len(calls) == cfg.num_layers * b.steps
        assert {s for s, _ in calls} == {(2, pad + horizon, 2, 64)}
        assert any(dead for _, dead in calls)  # a free row, masked whole
    else:
        assert not calls


def test_speculative_batcher_matches_solo():
    rng = np.random.default_rng(7)
    phrase = list(rng.integers(1, CFG.vocab_size, 4))
    prompts = [phrase * 3, list(rng.integers(1, CFG.vocab_size, 9)),
               phrase * 2 + [7]]
    news = [12, 9, 11]
    got, want, tc, jc = run_both(
        dict(slots=4, prompt_pad=16, horizon=96, chunk=3, spec_k=3),
        [(p, dict(max_new=n)) for p, n in zip(prompts, news)])
    assert got == want and tc == jc
    for p, n, toks in zip(prompts, news, got):
        assert toks == _solo(p, n, 16), (p, n, toks)


def test_speculative_batcher_compaction_and_eos():
    rng = np.random.default_rng(8)
    prompts = _prompts(3, rng)

    async def run(prompts, **kw):
        b = batcher(slots=2, prompt_pad=8, horizon=32, chunk=2, spec_k=3)
        outs = await asyncio.gather(*[
            b.submit(p[:6], max_new=14, **kw) for p in prompts])
        return outs, b.compactions

    got, compactions = asyncio.run(run(prompts))
    assert compactions > 0
    for p, toks in zip(prompts, got):
        assert toks == _solo(p[:6], 14, 8), p
    eos = _solo(prompts[0][:6], 14, 8)[2]
    (alone,), _ = asyncio.run(run(prompts[:1], eos_id=eos))
    assert alone == _solo(prompts[0][:6], 14, 8, eos_id=eos)


def test_speculative_batcher_composes_with_kv_quant():
    rng = np.random.default_rng(9)
    phrase = list(rng.integers(1, CFG.vocab_size, 4))
    prompts = [phrase * 3, list(rng.integers(1, CFG.vocab_size, 7))]

    async def run():
        b = batcher(QCFG, slots=2, prompt_pad=16, horizon=64, chunk=2,
                    spec_k=3)
        return await asyncio.gather(*[b.submit(p, max_new=10)
                                      for p in prompts])

    for p, toks in zip(prompts, asyncio.run(run())):
        assert toks == _solo(p, 10, 16, cfg=QCFG), p


def test_first_token_eos_latches_row():
    rng = np.random.default_rng(21)
    prompt = list(rng.integers(1, CFG.vocab_size, 7))
    first = _solo(prompt, 1, 16)[0]

    async def run(spec_k):
        b = batcher(slots=2, prompt_pad=16, horizon=48, chunk=4,
                    spec_k=spec_k)
        return await b.submit(prompt, max_new=10, eos_id=first)

    assert asyncio.run(run(0)) == []
    assert asyncio.run(run(3)) == []


def test_prefix_overflow_falls_back_to_full_prefill():
    header = list(np.random.default_rng(24).integers(1, CFG.vocab_size, 18))
    prompt = header + list(np.random.default_rng(25).integers(
        1, CFG.vocab_size, 14))

    async def run():
        b = batcher(slots=1, prompt_pad=32, horizon=1, chunk=1)
        b.register_prefix(header)
        return await b.submit(prompt, max_new=1), b.prefix_hits

    out, hits = asyncio.run(run())
    assert hits == 0
    assert out == _solo(prompt, 1, 32)


def test_prefix_cached_admission_matches_solo():
    rng = np.random.default_rng(12)
    header = list(rng.integers(1, CFG.vocab_size, 11))
    tails = [list(rng.integers(1, CFG.vocab_size, n)) for n in (3, 5, 1)]
    prompts = [header + t for t in tails]
    other = list(rng.integers(1, CFG.vocab_size, 6))
    got, want, tc, jc = run_both(
        dict(slots=2, prompt_pad=32, horizon=48, chunk=4),
        [(p, dict(max_new=8)) for p in prompts + [other]], prefix=header)
    assert tc[1] == 3 and tc == jc and got == want
    for p, toks in zip(prompts + [other], got):
        assert toks == _solo(p, 8, 32), p


def test_prefix_cache_composes_with_speculation():
    rng = np.random.default_rng(13)
    header = list(rng.integers(1, CFG.vocab_size, 9))
    prompts = [header + list(rng.integers(1, CFG.vocab_size, n))
               for n in (2, 4)]

    async def run():
        b = batcher(slots=2, prompt_pad=16, horizon=64, chunk=2, spec_k=3)
        b.register_prefix(header)
        outs = await asyncio.gather(*[b.submit(p, max_new=10)
                                      for p in prompts])
        return outs, b.prefix_hits

    got, hits = asyncio.run(run())
    assert hits == 2
    for p, toks in zip(prompts, got):
        assert toks == _solo(p, 10, 16), p


def test_batcher_serves_tp_sharded_params():
    """Multi-device serving: the SAME batcher runs over TP-sharded params
    (`tp.shard_params`, the megatron-style rule over the model axis of an
    8-device CPU mesh) and gives token-identical output; the scheduler
    never changes."""
    from rag_application_tpu_torch.parallel import tp
    from rag_application_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, model=2, devices=[torch.device("cpu")] * 8)
    sharded = tp.shard_params(mesh, tparams(CFG))
    rng = np.random.default_rng(10)
    prompts = _prompts(3, rng)
    news = [8, 11, 6]

    async def run(params):
        b = ContinuousBatcher(params, tcfg(CFG), slots=2, prompt_pad=16,
                              horizon=48, chunk=4)
        return await asyncio.gather(*[
            b.submit(p, max_new=n) for p, n in zip(prompts, news)])

    base = asyncio.run(run(tparams(CFG)))
    shard = asyncio.run(run(sharded))
    assert shard == base


def test_adaptive_speculation_throttles_and_stays_exact():
    rng = np.random.default_rng(15)
    prompts = _prompts(3, rng)
    got, want, tc, jc = run_both(
        dict(slots=2, prompt_pad=16, horizon=64, chunk=2, spec_k=3,
             spec_min_tps=4.5, spec_cooldown=4),
        [(p, dict(max_new=12)) for p in prompts])
    assert tc[2] >= 1 and tc[3] >= 1  # probed, then throttled
    assert tc == jc and got == want
    for p, toks in zip(prompts, got):
        assert toks == _solo(p, 12, 16), p


def test_adaptive_speculation_sampled_mode():
    rng = np.random.default_rng(16)
    prompt = list(rng.integers(1, CFG.vocab_size, 6))

    def run_once():
        async def run():
            b = batcher(slots=1, prompt_pad=8, horizon=48, chunk=2,
                        spec_k=2, temperature=0.8, top_k=32, top_p=0.9,
                        spec_min_tps=4.0, spec_cooldown=3)
            return await b.submit(prompt, max_new=10), b.plain_dispatches

        return asyncio.run(run())

    a, plain_a = run_once()
    b, _ = run_once()
    assert a == b and len(a) == 10
    assert plain_a >= 1
    assert all(0 <= t < CFG.vocab_size for t in a)


def test_sampled_speculative_batcher():
    rng = np.random.default_rng(14)
    prompt = list(rng.integers(1, CFG.vocab_size, 6))

    def run_once(seed, temp):
        async def run():
            b = batcher(slots=2, prompt_pad=8, horizon=32, chunk=2,
                        spec_k=3, temperature=temp, top_k=32, top_p=0.9,
                        seed=seed)
            return await b.submit(prompt, max_new=12), b.compactions

        return asyncio.run(run())

    a, _ = run_once(0, 0.8)
    b, _ = run_once(0, 0.8)
    c, _ = run_once(5, 0.8)
    assert a == b and len(a) == 12
    assert all(0 <= t < CFG.vocab_size for t in a)
    assert a != c
    cold, compactions = run_once(0, 1e-4)
    assert compactions > 0
    assert cold == _solo(prompt, 12, 8)


WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "system", "user",
         "assistant", ":", "hello", "world", "weather", "sunny",
         "how", "is", "the", "today", "a", "fine"]


def _llm_pair(words, seed, **dims):
    from rag_application_tpu.llm.local import LocalLLM as JLocal
    from rag_application_tpu.models.wordpiece import WordPieceTokenizer as JT
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer

    cfg = jdec.DecoderConfig(vocab_size=len(words), hidden=32, num_layers=2,
                             heads=4, kv_heads=2, mlp_dim=64, max_len=64,
                             dtype="float32")
    params = jdec.init_decoder_params(jax.random.PRNGKey(seed), cfg)
    tp = decoder_params_from_jax({k: np.asarray(v) for k, v in
                                  params.items()}, tcfg(cfg), "cpu")
    j = JLocal(params, cfg, JT.from_vocab_list(words, native=False),
               model_name="tiny")
    return j, lambda: LocalLLM(
        tp, tcfg(cfg), WordPieceTokenizer.from_vocab_list(words,
                                                          native=False),
        model_name="tiny", device="cpu")


def test_local_llm_batched_chat_matches_solo_chat():
    """LocalLLM.chat through enable_batching: the JAX solo chat's texts,
    and the concurrent chats went through the batch."""
    from rag_application_tpu_torch.llm.router import ChatMessage

    j, make = _llm_pair(WORDS, 7)
    convs = [[ChatMessage("user", "hello how is the weather")],
             [ChatMessage("user", "the weather today")],
             [ChatMessage("user", "sunny world hello")]]

    async def main():
        want = [(await j.chat(m, max_tokens=8)).content for m in convs]
        batched = make()
        batched.enable_batching(slots=2, prompt_pad=32, horizon=32, chunk=4)
        got = await asyncio.gather(*[batched.chat(m, max_tokens=8)
                                     for m in convs])
        assert batched._batcher.steps > 0
        return want, [r.content for r in got]

    want, got = asyncio.run(main())
    assert got == want


def test_long_prompt_bypasses_batcher():
    from rag_application_tpu_torch.llm.router import ChatMessage

    j, make = _llm_pair(WORDS, 7)
    long_msg = [ChatMessage("system", "the weather today is fine"),
                ChatMessage("user", " ".join(["hello world"] * 6))]

    async def main():
        want = (await j.chat(long_msg, max_tokens=6)).content
        batched = make()
        b = batched.enable_batching(slots=2, prompt_pad=8, horizon=16,
                                    chunk=4)
        assert len(batched.render(long_msg)) > 8
        got = (await batched.chat(long_msg, max_tokens=6)).content
        return want, got, b.steps

    want, got, steps = asyncio.run(main())
    assert got == want
    assert steps == 0


def test_local_llm_batched_stream_matches_solo_stream():
    from rag_application_tpu_torch.llm.router import ChatMessage

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "user", "assistant",
             ":", "hello", "world", "sunny", "fine", "a", "the"]
    j, make = _llm_pair(words, 9)
    convs = [[ChatMessage("user", "hello world")],
             [ChatMessage("user", "the sunny a fine")]]

    async def collect(llm, msgs):
        return [d async for d in llm.stream(msgs, max_tokens=6)]

    async def main():
        want = [await collect(j, m) for m in convs]
        batched = make()
        batched.enable_batching(slots=2, prompt_pad=16, horizon=16, chunk=2)
        got = await asyncio.gather(*[collect(batched, m) for m in convs])
        assert batched._batcher.steps > 0
        return want, got

    want, got = asyncio.run(main())
    assert ["".join(g) for g in got] == ["".join(w) for w in want]


def test_sampled_mode_runs():
    rng = np.random.default_rng(6)
    prompts = _prompts(2, rng)

    def run_once():
        async def run():
            b = batcher(slots=2, prompt_pad=16, horizon=32, chunk=4,
                        temperature=0.8, top_k=16, top_p=0.9, seed=7)
            return await asyncio.gather(*[b.submit(p, max_new=6)
                                          for p in prompts])

        return asyncio.run(run())

    got = run_once()
    assert got == run_once()  # seeded by (seed, step) and (seed, request)
    for toks in got:
        assert len(toks) == 6
        assert all(0 <= t < CFG.vocab_size for t in toks)


def test_sampled_first_token_follows_the_law():
    """The first token of each request is drawn at admission from the
    prefill's filtered distribution, with a generator of its own (seed,
    request id): over 768 requests of one prompt its frequencies match
    `_filtered_probs` of the JAX prefill's logits (4.5 sigma)."""
    from rag_application_tpu.models.speculative import _filtered_probs

    prompt = [5, 9, 17, 3, 44]
    temp, top_k, top_p, n = 1.3, 12, 0.95, 768
    ids = np.zeros((1, 8), np.int32)
    ids[0, :5] = prompt
    ck, cv = jdec.init_kv_cache(CFG, 1, 8)
    logits, _, _ = jdec.prefill(PARAMS[CFG], CFG, ids,
                                np.asarray([5], np.int32), ck, cv)
    p = np.asarray(_filtered_probs(logits[0], temperature=temp, top_k=top_k,
                                   top_p=top_p))

    async def run():
        b = batcher(slots=8, prompt_pad=8, horizon=8, chunk=1,
                    temperature=temp, top_k=top_k, top_p=top_p, seed=3)
        return await asyncio.gather(*[b.submit(prompt, max_new=1)
                                      for _ in range(n)])

    first = np.asarray([o[0] for o in asyncio.run(run())])
    assert p[first].min() > 0  # every draw inside the top-k / top-p set
    emp = np.bincount(first, minlength=CFG.vocab_size) / n
    np.testing.assert_array_less(np.abs(emp - p),
                                 4.5 * np.sqrt(p * (1 - p) / n) + 1e-9)


def test_lookahead_row_reuse_safety():
    rng = np.random.default_rng(7)
    prompts = _prompts(8, rng)
    news = [3, 11, 6, 1, 9, 4, 12, 2]
    got, want, tc, jc = run_both(
        dict(slots=2, prompt_pad=16, horizon=48, chunk=2, lookahead=4),
        [(p, dict(max_new=n)) for p, n in zip(prompts, news)])
    assert got == want and tc == jc
    for p, n, toks in zip(prompts, news, got):
        assert toks == _solo(p, n, 16), (p, n)


def test_lookahead_zero_matches_pipelined():
    rng = np.random.default_rng(8)
    prompts = _prompts(3, rng)

    async def run(la):
        b = batcher(slots=2, prompt_pad=16, horizon=32, chunk=4,
                    lookahead=la)
        return await asyncio.gather(*[b.submit(p, max_new=8)
                                      for p in prompts])

    assert asyncio.run(run(0)) == asyncio.run(run(5))


def test_lookahead_spec_compaction_identity():
    rng = np.random.default_rng(9)
    prompts = _prompts(3, rng)

    async def run():
        b = batcher(slots=2, prompt_pad=8, horizon=24, chunk=2, spec_k=2,
                    lookahead=3)
        outs = await asyncio.gather(*[b.submit(p[:6], max_new=10)
                                      for p in prompts])
        return outs, b.compactions

    got, compactions = asyncio.run(run())
    assert compactions > 0
    for p, toks in zip(prompts, got):
        assert toks == _solo(p[:6], 10, 8), p


def test_eos_at_chunk_last_step_zombie_row():
    rng = np.random.default_rng(11)
    prompt = _prompts(1, rng)[0][:6]
    ref = _solo(prompt, 24, 8)

    async def run(eos):
        b = batcher(slots=1, prompt_pad=8, horizon=16, chunk=8, lookahead=2)
        first = await b.submit(prompt, max_new=18, eos_id=eos)
        second = await b.submit(prompt, max_new=18, eos_id=eos)
        return first, second

    for m in (14, 15, 16):
        eos = ref[m]
        assert eos not in ref[:m], "pick a prompt whose ref[m] is fresh"
        want = ref[:m]
        first, second = asyncio.run(run(eos))
        assert first == want, m
        assert second == want, m


def _rand_adapter(seed, r):
    """The reference test's adapter: wq and wv factors at CFG's widths,
    float32, with a stored scale 2."""
    key = jax.random.PRNGKey(seed)
    out = {}
    for t, fin, fout in (("wq", 64, 64), ("wv", 64, 32)):
        key, k1, k2 = jax.random.split(key, 3)
        out[t] = {"a": jax.random.normal(k1, (3, fin, r)) * 0.3,
                  "b": jax.random.normal(k2, (3, r, fout)) * 0.3,
                  "s": jnp.full((3, 1, 1), 2.0, jnp.float32)}
    return out


def _port_banks(trees):
    """The port's float32 banks of JAX adapter trees (carried as numpy),
    held bit-equal to the reference's `lora_banks` of the same trees."""
    want = jlora.lora_banks(trees, dtype=jnp.float32)
    got = tlora.lora_banks(
        [state.adapters_from_jax(jax.tree.map(np.asarray, t), "cpu")
         for t in trees], dtype=torch.float32)
    for t in want:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[t][k].numpy(),
                                          np.asarray(want[t][k]))
    return got


@functools.lru_cache(maxsize=None)
def _merged_solo(prompt, max_new, seed, r):
    """Reference: a JAX greedy `generate` with the adapter merged into
    the dense weights (seed 0 = the base), eos/pad stripped."""
    params = PARAMS[CFG] if not seed else jlora.lora_merge(
        jlora.lora_wrap_with(PARAMS[CFG], _rand_adapter(seed, r)))
    ids = np.zeros((1, 16), np.int32)
    ids[0, :len(prompt)] = prompt
    out, _ = jdec.generate(params, CFG, ids, np.asarray([len(prompt)],
                                                        np.int32),
                           max_new, -1, -7, jax.random.PRNGKey(0), 0.0)
    return [int(t) for t in np.asarray(out)[0] if int(t) != -7]


def test_multi_lora_batcher_matches_merged_solo():
    """Rows with DIFFERENT adapters decode in one shared batch; each
    row's greedy output equals the JAX package's solo run of its adapter
    merged into the dense weights."""
    banks = _port_banks([_rand_adapter(1, 4), _rand_adapter(2, 8)])
    rng = np.random.default_rng(3)
    prompts = _prompts(3, rng)
    aids, news = [0, 1, 2], [9, 11, 8]

    async def run():
        b = batcher(slots=3, prompt_pad=16, horizon=32, chunk=4,
                    lora_banks=banks)
        return await asyncio.gather(*[
            b.submit(p, max_new=n, adapter_id=a)
            for p, n, a in zip(prompts, news, aids)])

    got = asyncio.run(run())
    for p, n, a, toks in zip(prompts, news, aids, got):
        want = _merged_solo(tuple(int(t) for t in p), n, a, (0, 4, 8)[a])
        assert toks == want, (a, toks, want)
    assert got[1] != _merged_solo(tuple(int(t) for t in prompts[1]), 11, 0, 0)


def test_multi_lora_adapter_id_validation():
    """An adapter id outside the banks raises ValueError naming it, as
    in the reference: without banks any id but 0, with two adapters an
    id above 2 or below 0."""
    banks = _port_banks([_rand_adapter(1, 4), _rand_adapter(2, 8)])

    async def run(aid, **kw):
        b = batcher(slots=2, prompt_pad=16, horizon=32, chunk=4, **kw)
        try:
            await b.submit([1, 2, 3], max_new=4, adapter_id=aid)
        except ValueError as e:
            return str(e)
        return None

    for aid, kw in ((1, {}), (3, {"lora_banks": banks}),
                    (-1, {"lora_banks": banks})):
        msg = asyncio.run(run(aid, **kw))
        assert msg and "adapter_id" in msg, (aid, msg)
    assert asyncio.run(run(2, lora_banks=banks)) is None


def test_adapter_row_never_matches_base_prefix():
    """A registered prefix's K/V were computed through the base model, so
    an adapter row whose prompt starts with it takes a full prefill (no
    prefix hit) and still equals its merged solo run, while a base row
    with the same prompt hits the prefix."""
    banks = _port_banks([_rand_adapter(1, 4)])
    rng = np.random.default_rng(12)
    header = [int(t) for t in rng.integers(1, CFG.vocab_size, 6)]
    prompt = header + [int(t) for t in rng.integers(1, CFG.vocab_size, 4)]

    async def run(aid):
        b = batcher(slots=2, prompt_pad=16, horizon=32, chunk=4,
                    lora_banks=banks)
        b.register_prefix(header)
        return await b.submit(prompt, max_new=7, adapter_id=aid), \
            b.prefix_hits

    toks, hits = asyncio.run(run(1))
    assert hits == 0
    assert toks == _merged_solo(tuple(prompt), 7, 1, 4)
    toks, hits = asyncio.run(run(0))
    assert hits == 1
    assert toks == _merged_solo(tuple(prompt), 7, 0, 0)


def test_compact_gathers_both_int8_leaves():
    """`_compact` against a numpy re-pack: a stable sort of each row's
    slots by position, the int8 rows ("q", one more axis) and their
    scales ("s") moved together in the tensors given, the head the
    largest live count."""
    rng = np.random.default_rng(30)
    L, B, S, KVH, hd = 2, 3, 12, 2, 4
    slot_pos = np.where(rng.random((B, S)) < 0.4, DEAD,
                        rng.integers(0, 20, (B, S))).astype(np.int32)
    q = rng.integers(-127, 128, (L, B, S, KVH, hd)).astype(np.int8)
    s = rng.random((L, B, S, KVH)).astype(np.float32)
    ck = {"q": torch.tensor(q), "s": torch.tensor(s)}
    cv = {"q": torch.tensor(q), "s": torch.tensor(s)}
    nk, _, nsp, head = tsch._compact(ck, cv, torch.from_numpy(slot_pos))
    assert nk["q"] is ck["q"] and nk["s"] is ck["s"]  # re-packed in place
    order = np.argsort(slot_pos, axis=1, kind="stable")
    np.testing.assert_array_equal(nsp.numpy(),
                                  np.take_along_axis(slot_pos, order, 1))
    for b in range(B):
        np.testing.assert_array_equal(nk["q"][:, b].numpy(), q[:, b][:,
                                                                  order[b]])
        np.testing.assert_array_equal(nk["s"][:, b].numpy(), s[:, b][:,
                                                                  order[b]])
    assert head == int((slot_pos < DEAD).sum(1).max())
