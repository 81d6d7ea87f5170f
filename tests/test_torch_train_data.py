"""Parity of the port's contrastive training data (`models/train_data.py`)
with the JAX package's, case for case with tests/test_train_data.py.

The module is a copy over the port's `Collection` and `HashTokenizer`:
with the same numpy seed every pair builder returns the reference's
pairs, equal as Python objects, and `batches` the same ids and masks,
equal as arrays. `neighbor_pairs` reads two collections that ingested
the same documents, one of each package.
"""

import asyncio

import numpy as np
import pytest

from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.llm.router import LLMRouter as JRouter
from rag_application_tpu.llm.router import Provider as JProvider
from rag_application_tpu.models import train_data as jtd
from rag_application_tpu.models.tokenizer import HashTokenizer as JTok
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu_torch.config import Config, EncoderConfig, IndexConfig
from rag_application_tpu_torch.llm.router import LLMRouter, Provider
from rag_application_tpu_torch.models import train_data as ttd
from rag_application_tpu_torch.models.encoder import init_encoder
from rag_application_tpu_torch.models.tokenizer import HashTokenizer
from rag_application_tpu_torch.models.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)
from rag_application_tpu_torch.store.collection import Collection

WORDS = [f"w{i}" for i in range(40)] + ["alpha", "beta", "gamma", "delta"]


def _texts(seed, n=24):
    """Sentences of zipf-ish words, some short, some long."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(2, 60))
        words = [WORDS[min(int(rng.zipf(1.3)) - 1, len(WORDS) - 1)]
                 for _ in range(k)]
        for j in range(4, k, int(rng.integers(4, 9))):
            words[j] += "."
        out.append(" ".join(words))
    out.append("too short")
    return out


@pytest.mark.parametrize("builder, kw", [
    ("crop_pairs", {}),
    ("crop_pairs", {"min_words": 3}),
    ("ict_pairs", {}),
    ("ict_pairs", {"min_words": 4, "max_query_words": 5}),
    ("keyword_pairs", {}),
    ("keyword_pairs", {"per_text": 3, "min_terms": 2, "max_terms": 4}),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_pair_builders_match_reference(builder, kw, seed):
    texts = _texts(seed)
    want = getattr(jtd, builder)(texts, np.random.default_rng(seed), **kw)
    got = getattr(ttd, builder)(texts, np.random.default_rng(seed), **kw)
    assert want, builder  # the case exercises the builder
    assert got == want


def test_neighbor_pairs_match_reference():
    """Two collections, one per package, ingest the same documents (with
    a chunk without text and chunks stored out of order); the pairs are
    equal and in the same order."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = JConfig(), Config()
    jcfg.index = JIndexConfig(dim=16, matryoshka_dims=(), initial_capacity=16)
    tcfg.index = IndexConfig(dim=16, matryoshka_dims=(), initial_capacity=16)
    jcol, tcol = JCollection("td", jcfg), Collection("td", tcfg, device="cpu")
    docs = {
        "a": [{"text": f"a text {i}", "chunk_index": i} for i in (2, 0, 1)],
        "b": [{"text": "b only"}],
        "c": [{"text": f"c text {i}"} for i in range(4)] + [{"text": ""}],
    }
    for doc, payloads in docs.items():
        vecs = rng.standard_normal((len(payloads), 16)).astype(np.float32)
        jcol.store_document_vectors(doc, [dict(p) for p in payloads], vecs)
        tcol.store_document_vectors(doc, [dict(p) for p in payloads], vecs)
    want = jtd.neighbor_pairs(jcol)
    got = ttd.neighbor_pairs(tcol)
    assert len(want) == 5
    assert got == want


@pytest.mark.parametrize("drop", [True, False])
def test_batches_match_reference(drop):
    texts = _texts(5)
    pairs = (ttd.crop_pairs(texts, np.random.default_rng(1), min_words=3)
             + ttd.keyword_pairs(texts, np.random.default_rng(2)))
    jb = list(jtd.batches(pairs, JTok(256, 32), batch_size=8, max_len=24,
                          seed=4, drop_remainder=drop))
    tb = list(ttd.batches(pairs, HashTokenizer(256, 32), batch_size=8,
                          max_len=24, seed=4, drop_remainder=drop))
    assert len(tb) == len(jb) >= 2
    for t, j in zip(tb, jb):
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_llm_query_pairs_match_reference():
    texts = ["a passage about topics", "another passage", "a third"]

    def routers():
        j, t = JRouter(JProvider.STUB), LLMRouter(Provider.STUB)
        for r in (j, t):
            r.stub.on(r"search query", lambda p: "q: " + p.split("\n")[-1][:9])
        return j, t

    j, t = routers()
    want = asyncio.run(jtd.llm_query_pairs(texts, j, max_pairs=2))
    got = asyncio.run(ttd.llm_query_pairs(texts, t, max_pairs=2))
    assert len(want) == 2 and got == want


def test_batches_feed_train_step():
    """The port's `batches` drive the port's encoder step (the reference
    test's case): 20 pairs, two full batches of 8, finite losses."""
    cfg = EncoderConfig(vocab_size=256, hidden_dim=32, num_layers=1,
                        num_heads=4, mlp_dim=64, max_len=32, out_dim=16,
                        dtype="float32")
    tok = HashTokenizer(cfg.vocab_size, 32)
    pairs = [(f"question {i} about thing {i}",
              f"passage {i} covering thing {i}") for i in range(20)]
    enc = init_encoder(cfg, device="cpu")
    opt = make_optimizer(1e-3)
    step = make_train_step(enc.model, opt)
    state = init_train_state(enc.params, opt)
    n = 0
    for batch in ttd.batches(pairs, tok, batch_size=8, max_len=32):
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        n += 1
    assert n == 2 and state.step == 2
