"""Each generator repeats from its seed, and other seeds give other
inputs of the same sizes."""

import numpy as np
import pytest
import torch

from benchmark import data

from .conftest import SEED

CPU = torch.device("cpu")


def test_sub_seeds_take_large_seeds_and_differ_by_stream():
    a = data.sub_seed(SEED, 1)
    assert a == data.sub_seed(SEED, 1) and 0 <= a < 2 ** 63
    assert a != data.sub_seed(SEED, 2) != data.sub_seed(SEED + 1, 2)
    assert data.sub_seed(2 ** 40 + 3, 1) != data.sub_seed(3, 1)


def test_zipf_tokens_and_noisy_texts_repeat():
    t1 = data.synth_tokens(SEED, 500, 1000, 24)
    assert t1.shape == (500, 24) and t1.dtype == np.int32
    assert (t1 >= 0).all() and (t1 < 1000).all()
    assert np.array_equal(t1, data.synth_tokens(SEED, 500, 1000, 24))
    assert not np.array_equal(t1, data.synth_tokens(SEED + 1, 500, 1000, 24))
    # zipfian: the first term is by far the most frequent
    counts = np.bincount(t1.ravel(), minlength=1000)
    assert counts.argmax() == 0 and counts[0] > 5 * counts[100:].mean()
    idx = np.arange(0, 500, 7)
    n1 = data.noisy_tokens(t1, idx, SEED, 0.2, 1000)
    assert np.array_equal(n1, data.noisy_tokens(t1, idx, SEED, 0.2, 1000))
    kept = (n1 == t1[idx]).mean()
    assert 0.75 < kept < 0.9
    assert data.texts(n1[:1])[0] == " ".join(f"w{w}" for w in n1[0])


def test_corpus_and_query_pool_repeat():
    def corpus(seed):
        return torch.cat([x for _, x in data.corpus_slabs(
            seed, 3000, 32, 0.003, CPU)])

    a, b = corpus(SEED), corpus(SEED)
    assert a.shape == (3000, 32) and torch.equal(a, b)
    assert not torch.equal(a, corpus(SEED + 1))
    src = data.query_sources(SEED, 3000, 64)
    assert np.array_equal(src, data.query_sources(SEED, 3000, 64))
    q1 = data.query_pool(SEED, a[src], 0.05)
    assert q1.dtype == np.float32 and q1.shape == (64, 32)
    assert np.array_equal(q1, data.query_pool(SEED, a[src], 0.05))


def test_request_mix_same_sizes_for_every_seed_in_another_order():
    mix = {"context_tokens": [1024, 3072], "question_tokens": [16, 48],
           "new_tokens": [128, 256]}
    a = data.request_mix(SEED, 32, 8, mix)
    assert a == data.request_mix(SEED, 32, 8, mix)
    b = data.request_mix(SEED + 1, 32, 8, mix)
    assert a != b
    flat = sorted(tuple(sorted(r.items())) for c in a for r in c)
    assert flat == sorted(tuple(sorted(r.items())) for c in b for r in c)
    for client in a:
        assert len(client) == 8
        for x, y in zip(client[::2], client[1::2]):
            # pairs carry the same work: their sizes add to the range ends
            assert x["context"] + y["context"] == 1024 + 3072
            assert x["new"] + y["new"] == 128 + 256
            assert 1024 <= x["context"] <= 3072 and 16 <= x["question"] <= 48


@pytest.mark.parametrize("name", ["wq", "w_down", "tok_emb"])
def test_decoder_leaves_repeat(name):
    cfg = {"num_hidden_layers": 2, "hidden_size": 64,
           "intermediate_size": 96, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 50}
    w = data.decoder_leaf(SEED, cfg, name, CPU)
    shape, fan_in = data.decoder_shapes(cfg)[name]
    assert w.shape == shape and w.dtype == torch.bfloat16
    assert torch.equal(w, data.decoder_leaf(SEED, cfg, name, CPU))
    assert not torch.equal(w, data.decoder_leaf(SEED + 1, cfg, name, CPU))
    assert abs(float(w.float().std()) * fan_in ** 0.5 - 1.0) < 0.2
    p = data.prompt_tokens(SEED, 7, 40, 50)
    assert p == data.prompt_tokens(SEED, 7, 40, 50) and min(p) >= 3
