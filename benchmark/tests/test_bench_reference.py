"""The plain reference against brute force at tiny sizes, and against a
second witness where the repository has one."""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import decoder as rdec
from benchmark.reference import search as rsearch

from .conftest import SEED

CPU = torch.device("cpu")
SCFG = {"rows": 2000, "dim": 48, "spectral_decay": 0.003}


def _corpus():
    return torch.cat([x for _, x in data.corpus_slabs(
        SEED, SCFG["rows"], SCFG["dim"], SCFG["spectral_decay"], CPU)])


def test_dense_topk_is_brute_force():
    x = _corpus().double()
    q = torch.randn((20, SCFG["dim"]), generator=torch.Generator()
                    .manual_seed(1)).float()
    got = rsearch.dense_topk(SEED, SCFG, q, 10)
    xb = (x / x.norm(dim=1, keepdim=True)).float().to(torch.bfloat16)
    qb = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    scores = (qb.double() @ xb.double().T).numpy()
    for i in range(len(q)):
        # ties to the smaller id: sort by (-score, id)
        want = np.lexsort((np.arange(SCFG["rows"]), -scores[i]))[:10]
        assert np.array_equal(got[i], want)


def test_dense_topk_int8_control_is_brute_force():
    x = _corpus()
    q = torch.randn((8, SCFG["dim"]), generator=torch.Generator()
                    .manual_seed(2)).float()
    got = rsearch.dense_topk(SEED, SCFG, q, 5, "int8")
    xi = torch.clamp(torch.round(x / x.norm(dim=1, keepdim=True) * 127),
                     -127, 127).long()
    qi = torch.clamp(torch.round(q / q.norm(dim=1, keepdim=True) * 127),
                     -127, 127).long()
    scores = (qi @ xi.T).numpy()
    for i in range(len(q)):
        top = set(np.argsort(-scores[i], kind="stable")[:5].tolist())
        # integer scores tie: every pick must score at least the 5th best
        assert (scores[i][got[i]] >= np.sort(scores[i])[-5]).all()
        assert len(top & set(got[i].tolist())) >= 4


def test_bm25_is_brute_force_and_agrees_with_the_ports_oracle():
    tokens = data.synth_tokens(SEED, 300, 60, 24)
    bm = rsearch.BM25(tokens, 60, 1.2, 0.75, CPU)
    n = len(tokens)
    df = np.array([sum(t in set(row) for row in tokens) for t in range(60)])
    idf = np.log(1 + (n - df + 0.5) / (df + 0.5))
    q = np.array([0, 3, 3, 17, 42])
    docs = np.arange(0, 300, 13)
    want = []
    for d in docs:
        row = list(tokens[d])
        s = 0.0
        for t in set(q.tolist()):
            tf = row.count(t)
            s += idf[t] * tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * 24 / 24))
        want.append(s)
    assert np.allclose(bm.all_scores(q).numpy()[docs], want, rtol=1e-12)
    # a second witness: the port's host oracle over the same documents
    from rag_application_tpu_torch.config import SparseConfig
    from rag_application_tpu_torch.index.sparse import SparseIndex

    sp = SparseIndex(SparseConfig(), device="cpu")
    sp.analyzer.vocab = {f"w{t}": t for t in range(60)}
    sp.add_pretokenized(tokens)
    port = sp.exact_scores(" ".join(f"w{t}" for t in q))
    assert np.allclose(port[docs], want, rtol=1e-5)


DCFG = {"num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 96,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 50, "rms_norm_eps": 1e-5, "rope_theta": 1e6}


def test_reference_decoder_matches_the_ports_float32_forward():
    """The reference and the port's decoder compute one architecture:
    the port, given the reference's dequantized weights in float32 with
    a float32 cache, gives the reference's logits."""
    from rag_application_tpu_torch.models import decoder as pdec

    w = rdec.Weights(SEED, DCFG, CPU)
    params = {name: w.get(name) if w.leaves[name].codes.dim() == 2 else
              torch.stack([w.get(name, i) for i in range(2)])
              for name in data.DECODER_LEAVES}
    params.update(attn_norm=torch.ones(2, 64), ffn_norm=torch.ones(2, 64),
                  final_norm=torch.ones(64))
    cfg = pdec.DecoderConfig(vocab_size=50, hidden=64, num_layers=2,
                             heads=4, kv_heads=2, mlp_dim=96, max_len=64,
                             rope_theta=1e6, eps=1e-5, dtype="float32")
    ids = data.prompt_tokens(SEED, 3, 20, 50)
    ck, cv = pdec.init_kv_cache(cfg, 1, 32, device="cpu")
    hidden, _, _ = pdec.forward(
        params, cfg, torch.tensor([ids]), torch.arange(20)[None], ck, cv)
    port = pdec._project(params, cfg, hidden[0])
    ref = rdec.logits(w, ids, 0)
    assert torch.allclose(port, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits,qmax", [(8, 127), (4, 7)])
def test_reference_quantization_is_per_output_channel(bits, qmax):
    w = torch.tensor([[0.5, -1.0, 0.1], [0.3, 2.0, -0.7]],
                     dtype=torch.bfloat16)
    p = rdec._Packed(w, -2, bits)
    # columns are output channels: one scale max|w| / qmax a column
    want = w.float().abs().amax(dim=0) / qmax
    assert torch.allclose(p.scale[0], want)
    assert p.codes.abs().amax(dim=0).tolist() == [qmax] * 3
    err = (p.f32(-1) - w.float()).abs()
    assert (err <= want / 2 + 1e-7).all()


def test_served_gaps_read_zero_for_the_references_own_tokens():
    w = rdec.Weights(SEED, DCFG, CPU)
    prompt = data.prompt_tokens(SEED, 4, 12, 50)
    served = []
    for _ in range(6):  # greedy by the reference itself
        served.append(int(rdec.logits(w, prompt + served, 0)[-1].argmax()))
    gaps = rdec.served_gaps(w, prompt, served)
    assert gaps.shape == (6,) and float(gaps.max()) == 0.0
    other = [(t + 1) % 50 for t in served]
    assert float(rdec.served_gaps(w, prompt, other).max()) > 0.0
