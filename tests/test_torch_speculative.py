"""Parity of the port's prompt-lookup speculative decoding
(`models/speculative.py`) with the JAX package's, case for case with
tests/test_speculative.py, on the JAX decoder weights carried across by
`state.decoder_params_from_jax`.

Greedy output must equal the JAX plain `generate` token for token (and
the JAX `generate_lookup`'s, with the same number of block steps) for any
prompt, acceptance pattern, eos placement and k_spec. Sampled
speculation draws from a `torch.Generator`: it is held to its seed, to
validity, and, through `_filtered_probs` and `_sampled_verify`, to the
target law by Monte Carlo (20,000 draws, 0.02 absolute, as the
reference's tests).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.models import decoder as jdec
from rag_application_tpu.models import speculative as jspec
from rag_application_tpu_torch.models import decoder as tdec
from rag_application_tpu_torch.models import speculative as tspec
from rag_application_tpu_torch.state import decoder_params_from_jax

CFG = jdec.DecoderConfig(vocab_size=128, hidden=64, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=128, max_len=256,
                         dtype="float32")
PARAMS = jdec.init_decoder_params(jax.random.PRNGKey(3), CFG)
TCFG = tdec.DecoderConfig(**dataclasses.asdict(CFG))
TPARAMS = decoder_params_from_jax({k: np.asarray(v) for k, v in
                                   PARAMS.items()}, TCFG, "cpu")
KEY = jax.random.PRNGKey(0)


def _greedy(ids, plen, max_new, eos=-1):
    out, n = jdec.generate(PARAMS, CFG, jnp.asarray(ids),
                           jnp.asarray(plen, jnp.int32), max_new, eos, -9,
                           KEY, 0.0)
    return np.asarray(out), np.asarray(n)


def _spec(ids, plen, max_new, eos=-1, k=4):
    out, n = tspec.generate_lookup(TPARAMS, TCFG, ids,
                                   np.asarray(plen, np.int32), max_new, eos,
                                   -9, None, k)
    return out.numpy(), n.numpy()


@pytest.mark.parametrize("seed,t,k", [(0, 12, 4), (1, 7, 2), (2, 20, 6)])
def test_token_identical_to_plain_generate(seed, t, k):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, (1, t)).astype(np.int32)
    ref, rn = _greedy(ids, [t], 24)
    got, gn = _spec(ids, [t], 24, k=k)
    assert (got == ref).all(), (got, ref)
    assert (gn == rn).all()


def test_token_identical_fuzz():
    rng = np.random.default_rng(99)
    for _ in range(8):
        ids = rng.integers(0, CFG.vocab_size, (1, 16)).astype(np.int32)
        ref, rn = _greedy(ids, [16], 24)
        got, gn = _spec(ids, [16], 24, k=4)
        assert (got == ref).all() and (gn == rn).all()


def test_repetitive_prompt_accepts_drafts():
    """A repeated-phrase prompt: the same tokens as plain generate, and
    the same number of block steps as the JAX `generate_lookup_stats`
    (acceptance decisions agree block for block)."""
    phrase = [5, 9, 17, 3]
    ids = np.asarray([phrase * 4], np.int32)
    t = ids.shape[1]
    ref, _ = _greedy(ids, [t], 32)
    out, n, steps = tspec.generate_lookup_stats(
        TPARAMS, TCFG, ids, np.asarray([t], np.int32), 32, -1, -9, None, 4)
    _, _, jsteps = jspec.generate_lookup_stats(
        PARAMS, CFG, jnp.asarray(ids), jnp.asarray([t], jnp.int32), 32, -1,
        -9, KEY, 4)
    assert (out.numpy() == ref).all()
    assert steps == int(np.asarray(jsteps))
    assert int(np.ceil((32 - 1) / 5)) <= steps <= 32
    toks = out.numpy()[0]
    bigrams = set(zip(toks[:-1], toks[1:]))
    if len(bigrams) < len(toks) - 4:
        assert steps < 31, (steps, toks)


def test_eos_stops_and_pads():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, CFG.vocab_size, (1, 9)).astype(np.int32)
    ref, _ = _greedy(ids, [9], 16)
    eos = int(ref[0, 3])
    ref2, rn2 = _greedy(ids, [9], 16, eos=eos)
    got, gn = _spec(ids, [9], 16, eos=eos)
    assert (got == ref2).all(), (got, ref2)
    assert (gn == rn2).all()


def test_ragged_prompt_and_padding():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, CFG.vocab_size, (1, 16)).astype(np.int32)
    got, _ = _spec(ids, [10], 12)
    solo, _ = _spec(ids[:, :10], [10], 12)
    ref, _ = _greedy(ids, [10], 12)
    assert (got == solo).all() and (got == ref).all()


def test_rejects_batch():
    with pytest.raises(ValueError, match="single-row"):
        _spec(np.zeros((2, 4), np.int32), [4, 4], 8)


def test_filtered_probs_matches_sample_logits():
    """`_filtered_probs` equals the JAX one, and it is the law the port's
    `sample_logits` draws from: 20,000 draws within 0.02 of it."""
    logits = np.random.default_rng(0).normal(0, 2, (8,)).astype(np.float32)
    p = tspec._filtered_probs(torch.from_numpy(logits), temperature=0.7,
                              top_k=5, top_p=0.8).numpy()
    pj = np.asarray(jspec._filtered_probs(jnp.asarray(logits),
                                          temperature=0.7, top_k=5,
                                          top_p=0.8))
    np.testing.assert_allclose(p, pj, rtol=1e-6, atol=1e-7)
    assert abs(p.sum() - 1.0) < 1e-5
    assert (p > 0).sum() <= 5

    rows = torch.from_numpy(np.repeat(logits[None], 20000, axis=0))
    draws = tdec.sample_logits(rows, torch.Generator().manual_seed(1),
                               temperature=0.7, top_k=5, top_p=0.8)
    emp = np.bincount(draws.numpy(), minlength=8) / 20000.0
    np.testing.assert_allclose(emp, p, atol=0.02)


def test_sampled_verify_preserves_the_target_law():
    """Rejection-sampled verification (rows of a batch as independent
    draws): accepted positions echo the draft, the first emitted token's
    marginal is the target row 0, acceptance at position 0 is
    p_0(draft_0), and the bonus position draws from row K."""
    rng = np.random.default_rng(3)
    V, K, n = 8, 3, 20000
    probs = rng.dirichlet(np.ones(V), size=K + 1).astype(np.float32)
    draft = torch.tensor([2, 5, 0], dtype=torch.int32)
    g, accept = tspec._sampled_verify(
        torch.from_numpy(probs).expand(n, K + 1, V), draft.expand(n, K),
        torch.Generator().manual_seed(2))
    g, accept = g.numpy(), accept.numpy()
    assert g.shape == (n, K + 1) and accept.shape == (n, K)
    assert (g[:, 0][accept[:, 0]] == 2).all()
    emp = np.bincount(g[:, 0], minlength=V) / n
    np.testing.assert_allclose(emp, probs[0], atol=0.02)
    assert abs(accept[:, 0].mean() - probs[0, 2]) < 0.02
    emp_k = np.bincount(g[:, K], minlength=V) / n
    np.testing.assert_allclose(emp_k, probs[K], atol=0.02)


def test_sampled_lookup_generates_seeded_and_valid():
    rng = np.random.default_rng(31)
    ids = rng.integers(0, CFG.vocab_size, (1, 12)).astype(np.int32)

    def sample(seed, temp, eos=-1):
        out, n = tspec.generate_lookup(
            TPARAMS, TCFG, ids, np.asarray([12], np.int32), 16, eos, -9,
            torch.Generator().manual_seed(seed), 4, temp, 32, 0.9)
        return out.numpy(), n.numpy()

    o1, _ = sample(0, 0.8)
    o2, _ = sample(0, 0.8)
    o3, _ = sample(7, 0.8)
    assert (o1 == o2).all()
    assert ((o1 >= -9) & (o1 < CFG.vocab_size)).all()
    assert not (o1 == o3).all()
    cold, _ = sample(0, 1e-4)
    ref, _ = _greedy(ids, [12], 16)
    assert (cold == ref).all()
    eos = int(o1[0, 1])
    oe, ne = sample(0, 0.8, eos)
    oe = oe[0]
    stopped = np.where(oe == eos)[0]
    if stopped.size:
        assert (oe[stopped[0] + 1:] == -9).all()
    assert int(ne[0]) == int((oe != -9).sum())


def test_local_llm_speculative_chat_matches_plain():
    """LocalLLM(speculative=True): the greedy chat text equals the JAX
    speculative chat's and the port's plain chat's."""
    from rag_application_tpu.llm.local import LocalLLM as JLocal
    from rag_application_tpu.models.wordpiece import WordPieceTokenizer as JT
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.llm.router import ChatMessage
    from rag_application_tpu_torch.models.wordpiece import WordPieceTokenizer

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "system", "user",
             "assistant", ":", "you", "are", "helpful", "hello", "world",
             "how", "is", "the", "weather", "today", "fine", "sunny"]
    cfg = jdec.DecoderConfig(vocab_size=len(words), hidden=32, num_layers=2,
                             heads=4, kv_heads=2, mlp_dim=64, max_len=64,
                             dtype="float32")
    params = jdec.init_decoder_params(jax.random.PRNGKey(7), cfg)
    tcfg = tdec.DecoderConfig(**dataclasses.asdict(cfg))
    tp = decoder_params_from_jax({k: np.asarray(v) for k, v in
                                  params.items()}, tcfg, "cpu")
    tok = WordPieceTokenizer.from_vocab_list(words, native=False)
    plain = LocalLLM(tp, tcfg, tok, model_name="tiny", device="cpu")
    spec = LocalLLM(tp, tcfg, tok, model_name="tiny", speculative=True,
                    device="cpu")
    jspec_llm = JLocal(params, cfg, JT.from_vocab_list(words, native=False),
                       model_name="tiny", speculative=True)
    msgs = [ChatMessage("user", "hello how is the weather today")]

    async def main():
        return [(await m.chat(msgs, max_tokens=10, temperature=0.0)).content
                for m in (plain, spec, jspec_llm)]

    a, b, c = asyncio.run(main())
    assert a == b == c and isinstance(a, str)
