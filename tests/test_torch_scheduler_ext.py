"""Parity of the port's extended sampling through the continuous batcher
(`llm/scheduler.py` sampling_ext) with the JAX package's, case for case
with tests/test_scheduler_ext.py: per-request grammar constraints,
OpenAI penalties and logit_bias ride per-row planes inside the shared
decode batch, and greedy tokens equal the JAX solo loop's
(`decoder.generate` with the same knobs), plain and speculative. The
constraint bank's LRU eviction and pins are held to the JAX batcher's
over one sequence of registrations. A LoRA row in an ext batcher gives
the tokens of the JAX solo `generate` with the reference's banks.
"""

import asyncio
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.llm.scheduler import ContinuousBatcher as JBatcher
from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models.constrain import compile_schema as jcompile
from rag_application_tpu_torch.llm.scheduler import ContinuousBatcher
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models.constrain import compile_schema
from rag_application_tpu_torch.state import decoder_params_from_jax

CFG = jdec.DecoderConfig(vocab_size=160, hidden=32, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=64, max_len=512, dtype="float32")
PARAMS = jdec.init_decoder_params(jax.random.PRNGKey(0), CFG)
TCFG = tdec.DecoderConfig(**dataclasses.asdict(CFG))
TPARAMS = decoder_params_from_jax({k: np.asarray(v) for k, v in
                                   PARAMS.items()}, TCFG, "cpu")
EOS = 158  # outside the grammar: only the accept-state mask allows it


class ByteTok:
    """Toy tokenizer: id i decodes to chr(i) for printable ASCII."""

    def decode(self, ids):
        return "".join(chr(i) if 32 <= i < 127 else "\x00" for i in ids)

    def encode(self, text):
        return [ord(c) if 32 <= ord(c) < 127 else 1 for c in text]


SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "minLength": 1, "maxLength": 6},
    "count": {"type": "integer", "minimum": 0, "maximum": 99999},
    "kind": {"enum": ["alpha", "beta"]},
}}
CON = compile_schema(SCHEMA, ByteTok(), CFG.vocab_size)
JCON = jcompile(SCHEMA, ByteTok(), CFG.vocab_size)
OTHER, THIRD = ({"enum": ["x", "yz"]}, {"type": "boolean"})


@functools.lru_cache(maxsize=None)
def _solo_cached(prompt, max_new, eos_id, constrained, presence, frequency,
                 bias_key):
    ids = np.zeros((1, 16), np.int32)
    ids[0, :len(prompt)] = prompt
    bias = None
    if bias_key is not None:
        bias = np.zeros((CFG.vocab_size,), np.float32)
        bias[bias_key[0]] = bias_key[1]
    out, _ = jdec.generate(PARAMS, CFG, ids,
                           np.asarray([len(prompt)], np.int32), max_new,
                           eos_id, -7, jax.random.PRNGKey(0), 0.0, 64, 1.0,
                           None, presence, frequency,
                           JCON.as_device() if constrained else None,
                           None if bias is None else jnp.asarray(bias))
    return [int(t) for t in np.asarray(out)[0] if int(t) not in (-7, eos_id)]


def _solo(prompt, max_new, *, eos_id=-1, constrained=False, presence=0.0,
          frequency=0.0, bias=None):
    """Reference: one JAX greedy `generate` run (prompt_pad 16), eos/pad
    stripped; `bias` is (token, value) for a one-hot logit_bias plane."""
    return _solo_cached(tuple(int(t) for t in prompt), max_new, eos_id,
                        constrained, presence, frequency, bias)


def _plane(bias):
    vec = np.zeros((CFG.vocab_size,), np.float32)
    vec[bias[0]] = bias[1]
    return vec


def _prompts(n, rng, hi=120):
    return [list(rng.integers(32, hi, rng.integers(3, 12)))
            for _ in range(n)]


def _ext_batcher(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prompt_pad", 16)
    kw.setdefault("horizon", 256)
    kw.setdefault("chunk", 4)
    return ContinuousBatcher(TPARAMS, TCFG, sampling_ext=True, **kw)


def test_constrained_request_matches_solo_and_parses():
    rng = np.random.default_rng(0)
    prompts = _prompts(3, rng)

    async def run():
        b = _ext_batcher()
        cid = b.register_constraint(CON)
        return await asyncio.gather(
            b.submit(prompts[0], max_new=120, eos_id=EOS, constraint_id=cid),
            b.submit(prompts[1], max_new=10),
            b.submit(prompts[2], max_new=120, eos_id=EOS, constraint_id=cid))

    con0, plain, con2 = asyncio.run(run())
    for p, got in ((prompts[0], con0), (prompts[2], con2)):
        assert got == _solo(p, 120, eos_id=EOS, constrained=True)
        doc = json.loads(ByteTok().decode(got))
        assert set(doc) == {"name", "count", "kind"}
    assert plain == _solo(prompts[1], 10)


def test_penalties_match_solo():
    rng = np.random.default_rng(1)
    prompts = [[40, 40, 41, 41, 41, 42], list(rng.integers(32, 120, 8))]

    async def run():
        b = _ext_batcher()
        return await asyncio.gather(
            b.submit(prompts[0], max_new=24, presence=0.7, frequency=1.3),
            b.submit(prompts[1], max_new=24, frequency=2.0))

    got = asyncio.run(run())
    assert got[0] == _solo(prompts[0], 24, presence=0.7, frequency=1.3)
    assert got[1] == _solo(prompts[1], 24, frequency=2.0)
    assert got[1] != _solo(prompts[1], 24)


def test_logit_bias_matches_solo():
    rng = np.random.default_rng(2)
    p = _prompts(1, rng)[0]

    async def run():
        b = _ext_batcher()
        return await b.submit(p, max_new=12, logit_bias=_plane((55, 30.0)))

    got = asyncio.run(run())
    assert got == _solo(p, 12, bias=(55, 30.0))
    assert 55 in got


def test_row_reuse_clears_ext_planes():
    rng = np.random.default_rng(3)
    plains = _prompts(4, rng)

    async def run():
        b = _ext_batcher(slots=2)
        cid = b.register_constraint(CON)
        first = await asyncio.gather(
            b.submit(plains[0], max_new=120, eos_id=EOS, constraint_id=cid,
                     presence=0.5, frequency=0.5,
                     logit_bias=_plane((60, 25.0))),
            b.submit(plains[1], max_new=6))
        second = await asyncio.gather(b.submit(plains[2], max_new=8),
                                      b.submit(plains[3], max_new=8))
        return first, second

    _, second = asyncio.run(run())
    assert second[0] == _solo(plains[2], 8)
    assert second[1] == _solo(plains[3], 8)


def test_ext_composes_with_lora_rows():
    """A constrained request and a LoRA-adapter request share one ext
    batch; each matches its own JAX solo reference (the constrained one
    `generate` with the grammar, the adapter one `generate` with the
    reference's banks)."""
    from rag_application_tpu.models import lora as jlora
    from rag_application_tpu_torch import state
    from rag_application_tpu_torch.models import lora as tlora

    wrapped = jlora.lora_init(jax.random.PRNGKey(7), PARAMS, r=2, alpha=8.0)
    tree = jax.tree.map(  # nonzero b so the adapter actually acts
        lambda v: v + 0.05 * jax.random.normal(
            jax.random.PRNGKey(8), v.shape, jnp.float32).astype(v.dtype),
        jlora.lora_adapters(wrapped))
    banks = jlora.lora_banks([tree], alpha=8.0, dtype=jnp.float32)
    np_tree = {t: {k: np.asarray(v).view(np.uint16) for k, v in ab.items()}
               for t, ab in tree.items()}  # bf16 factors as their bits
    tbanks = tlora.lora_banks([state.adapters_from_jax(np_tree, "cpu")],
                              alpha=8.0, dtype=torch.float32)
    for t in banks:
        for k in ("a", "b"):
            np.testing.assert_array_equal(tbanks[t][k].numpy(),
                                          np.asarray(banks[t][k]))
    rng = np.random.default_rng(4)
    prompts = _prompts(2, rng)

    async def run():
        b = _ext_batcher(lora_banks=tbanks)
        cid = b.register_constraint(CON)
        return await asyncio.gather(
            b.submit(prompts[0], max_new=120, eos_id=EOS,
                     constraint_id=cid),
            b.submit(prompts[1], max_new=8, adapter_id=1),
        )

    con_out, lora_out = asyncio.run(run())
    assert con_out == _solo(prompts[0], 120, eos_id=EOS, constrained=True)
    json.loads(ByteTok().decode(con_out))
    ids = np.zeros((1, 16), np.int32)
    ids[0, :len(prompts[1])] = prompts[1]
    out, _ = jdec.generate(PARAMS, CFG, ids,
                           np.asarray([len(prompts[1])], np.int32), 8, -1,
                           -7, jax.random.PRNGKey(0), 0.0, 64, 1.0,
                           {"aid": jnp.asarray([1], jnp.int32),
                            "banks": banks})
    want = [int(t) for t in np.asarray(out)[0] if int(t) != -7]
    assert lora_out == want
    assert lora_out != _solo(prompts[1], 8)


def test_validation_errors():
    async def run():
        plain = ContinuousBatcher(TPARAMS, TCFG, slots=2, prompt_pad=16,
                                  horizon=32, chunk=2)
        with pytest.raises(ValueError, match="sampling_ext"):
            await plain.submit([40, 41], presence=0.5)
        with pytest.raises(RuntimeError, match="sampling_ext"):
            plain.register_constraint(CON)
        ext = _ext_batcher()
        with pytest.raises(ValueError, match="constraint_id"):
            await ext.submit([40, 41], constraint_id=3)
        with pytest.raises(ValueError, match="logit_bias"):
            await ext.submit([40, 41], logit_bias=np.zeros(7, np.float32))

    asyncio.run(run())
    ContinuousBatcher(TPARAMS, TCFG, slots=2, prompt_pad=16, horizon=64,
                      chunk=2, spec_k=2, sampling_ext=True)


def test_local_llm_routes_ext_through_batcher():
    """LocalLLM.chat with a response schema / penalties rides the ext
    batcher and gives the JAX LocalLLM's solo texts."""
    from rag_application_tpu.llm.local import LocalLLM as JLocal
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage

    llm = LocalLLM(TPARAMS, TCFG, ByteTok(), eos_id=EOS, device="cpu")
    llm.enable_batching(slots=2, prompt_pad=512, horizon=256, chunk=4,
                        sampling_ext=True)
    jllm = JLocal(PARAMS, CFG, ByteTok(), eos_id=EOS)
    calls = [([ChatMessage("user", "emit")],
              dict(response_schema=SCHEMA, max_tokens=120)),
             ([ChatMessage("user", "hello")],
              dict(max_tokens=8, presence_penalty=0.5))]

    async def run(m):
        return await asyncio.gather(*[m.chat(msgs, **kw)
                                      for msgs, kw in calls])

    (r1, r2), (j1, j2) = asyncio.run(run(llm)), asyncio.run(run(jllm))
    doc = json.loads(r1.content)
    assert set(doc) == {"name", "count", "kind"}
    assert (r1.content, r2.content) == (j1.content, j2.content)
    assert r1.usage == j1.usage and r2.usage == j2.usage
    b = llm._batcher
    assert b.steps > 0 and b.stats()["tokens_out"] == (
        r1.usage["completion_tokens"] + r2.usage["completion_tokens"])
    assert sum(c is not None for c in b._cslots) == 1


def _bank_state(b):
    return (dict(b._cdigest), dict(b._cuse), dict(b._cpins),
            b._smax_bucket)


def test_constraint_bank_lru_and_memoization():
    """Memoized re-registration, LRU eviction of free slots at a fixed
    bank shape, and re-registration into a reused slot: the same ids,
    digests, ticks and bank tables as the JAX batcher; outputs
    solo-identical."""
    rng = np.random.default_rng(5)
    prompts = _prompts(3, rng)

    def sequence(b, compile_, con):
        other = compile_(OTHER, ByteTok(), CFG.vocab_size)
        third = compile_(THIRD, ByteTok(), CFG.vocab_size)
        ids = [b.register_constraint(con), b.register_constraint(con),
               b.register_constraint(other)]
        shape_before = np.asarray(b._cbanks["table"]).shape
        ids.append(b.register_constraint(third))     # evicts the first
        assert np.asarray(b._cbanks["table"]).shape == shape_before
        ids.append(b.register_constraint(con))       # evicts `other`
        return ids

    tb = _ext_batcher(max_constraints=2)
    jb = JBatcher(PARAMS, CFG, slots=2, prompt_pad=16, horizon=256, chunk=4,
                  sampling_ext=True, max_constraints=2)
    t_ids = sequence(tb, compile_schema, CON)
    assert t_ids == sequence(jb, jcompile, JCON) == [1, 1, 2, 1, 2]
    assert _bank_state(tb) == _bank_state(jb)
    for k in ("table", "accept"):
        np.testing.assert_array_equal(tb._cbanks[k].numpy(),
                                      np.asarray(jb._cbanks[k]))

    out = asyncio.run(tb.submit(prompts[0], max_new=120, eos_id=EOS,
                                constraint_id=t_ids[4]))
    assert out == _solo(prompts[0], 120, eos_id=EOS, constrained=True)
    json.loads(ByteTok().decode(out))


def test_constraint_bank_full_of_pinned_slots_raises():
    rng = np.random.default_rng(6)
    prompts = _prompts(2, rng)
    other = compile_schema(OTHER, ByteTok(), CFG.vocab_size)
    third = compile_schema(THIRD, ByteTok(), CFG.vocab_size)

    async def run():
        b = _ext_batcher(max_constraints=2)
        cid1 = b.register_constraint(CON)
        cid2 = b.register_constraint(other)
        t1 = asyncio.ensure_future(b.submit(
            prompts[0], max_new=120, eos_id=EOS, constraint_id=cid1))
        t2 = asyncio.ensure_future(b.submit(
            prompts[1], max_new=120, eos_id=EOS, constraint_id=cid2))
        await asyncio.sleep(0)
        assert b._cpins == {cid1: 1, cid2: 1}
        with pytest.raises(ValueError, match="pinned"):
            b.register_constraint(third)
        outs = await asyncio.gather(t1, t2)
        assert b._cpins == {}
        assert b.register_constraint(third) in (1, 2)
        return outs

    outs = asyncio.run(run())
    assert outs[0] == _solo(prompts[0], 120, eos_id=EOS, constrained=True)


def test_constrained_through_speculative_batcher_matches_solo():
    rng = np.random.default_rng(7)
    prompts = _prompts(3, rng)

    async def run():
        b = _ext_batcher(spec_k=4, horizon=640)
        cid = b.register_constraint(CON)
        outs = await asyncio.gather(
            b.submit(prompts[0], max_new=120, eos_id=EOS, constraint_id=cid),
            b.submit(prompts[1], max_new=24),
            b.submit(prompts[2], max_new=24, presence=0.7, frequency=1.3))
        return b, outs

    b, (con, plain, pen) = asyncio.run(run())
    assert con == _solo(prompts[0], 120, eos_id=EOS, constrained=True)
    doc = json.loads(ByteTok().decode(con))
    assert set(doc) == {"name", "count", "kind"}
    assert plain == _solo(prompts[1], 24)
    assert pen == _solo(prompts[2], 24, presence=0.7, frequency=1.3)
    assert b.tokens_out / max(b.steps, 1) > 1.0, (b.tokens_out, b.steps)


def test_spec_ext_row_reuse_and_eos_latch():
    rng = np.random.default_rng(8)
    prompts = _prompts(4, rng)

    async def run():
        b = _ext_batcher(slots=2, spec_k=2, horizon=640)
        cid = b.register_constraint(CON)
        first = await asyncio.gather(
            b.submit(prompts[0], max_new=120, eos_id=EOS, constraint_id=cid),
            b.submit(prompts[1], max_new=6))
        second = await asyncio.gather(
            b.submit(prompts[2], max_new=120, eos_id=EOS, constraint_id=cid),
            b.submit(prompts[3], max_new=8))
        return first, second

    first, second = asyncio.run(run())
    assert first[0] == _solo(prompts[0], 120, eos_id=EOS, constrained=True)
    assert second[0] == _solo(prompts[2], 120, eos_id=EOS, constrained=True)
    assert second[1] == _solo(prompts[3], 8)


def test_sampled_ext_batcher_is_seeded_and_valid():
    """A sampled ext batcher: the same seed gives the same tokens, and a
    constrained request still parses (the mask applies before the
    draw)."""
    rng = np.random.default_rng(9)
    prompts = _prompts(2, rng)

    def run_once(spec_k):
        async def run():
            b = _ext_batcher(temperature=0.9, top_k=32, top_p=0.95, seed=4,
                             spec_k=spec_k, horizon=640)
            cid = b.register_constraint(CON)
            return await asyncio.gather(
                b.submit(prompts[0], max_new=120, eos_id=EOS,
                         constraint_id=cid),
                b.submit(prompts[1], max_new=12, frequency=0.5))

        return asyncio.run(run())

    for spec_k in (0, 2):
        a = run_once(spec_k)
        assert a == run_once(spec_k)
        json.loads(ByteTok().decode(a[0]))
        assert len(a[1]) == 12
