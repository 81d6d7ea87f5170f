"""Parity of the port's evals (`evals/real_docs.py`, `evals/multimodal.py`)
with the JAX package's, on the CPU.

  * The host helpers (`extractive_answer`, `_dedupe_texts`, `_tokens`,
    `_norm`, `QUESTIONS`) give the reference's outputs on the reference
    test's strings.
  * `_retrieval_proxy` keeps the reference's duplicate-text defect: its
    ``{text: index}`` map keeps the last of equal texts, so a hit on an
    earlier duplicate is a miss. Both packages grade the same.
  * `build_real_docs_stack` over the reference test's subset
    (tests/test_real_docs.py) through both packages, the port's `Embedder`
    factory patched to hold the flax weights (`state.encoder_params_from_
    jax`) on the CPU: equal chunk texts, and equal per-question retrieved
    / answered flags on the subset's questions.
  * `train_multimodal`'s first 3 steps at the reference test's TINY
    tower, against the reference's step on the same batches: losses
    within 1e-5 relative, every gradient leaf's relative L2 error under
    1e-4 (f32; the two frameworks sum the products in other orders), and
    the weights after 3 steps within 1e-5 of the reference's, but the
    attention's key bias (KEY_BIAS at the test).
  * `evaluate_multimodal(steps=120)` above the reference test's floors.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.evals import multimodal as jmm
from rag_application_tpu.evals import real_docs as jrd
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, EncoderConfig
from rag_application_tpu_torch.evals import multimodal as tmm
from rag_application_tpu_torch.evals import real_docs as trd
from rag_application_tpu_torch.models import embedder as tembedder
from rag_application_tpu_torch.models.encoder import init_encoder

SUBSET_FILES = ["Resume.pdf", "ragas_papers.pdf"]
SUBSET_QUESTIONS = [
    q for q in jrd.QUESTIONS
    if "Vivek" in q[0] or "RAGAS" in q[0] or "Salesforce" in q[0]
    or "Oppenheimer" in q[0] or "chatbot" in q[0] or "Wiki" in q[0]
]
MM_TINY = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
               mlp_dim=64, max_len=32, out_dim=32, dtype="float32")


@pytest.fixture()
def one_torch_thread():
    """The suite runs several workers to a host, and a worker's small
    torch ops on every core spin against the others' (the 120-step
    multimodal run took 24x its lone time so): the tiny tower's training
    keeps to one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(coro):
    return asyncio.run(coro)


def carried_encoder(jparams, cfg, multimodal=False):
    """A port EncoderState on the CPU holding a flax param tree."""
    ts = init_encoder(cfg, device="cpu", multimodal=multimodal)
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return ts


# ------------------------------------------------------------ host helpers

CONTEXTS = [
    ("Which company did Vivek Malipatel work for in Bangalore?",
     "Vivek Malipatel worked at many companies. "
     "Vivek Malipatel studied computer science. "
     "He worked for PricewaterhouseCoopers in Bangalore, India."),
    ("Which university in Chicago?",
     "[Resume#0] EDUCATION\nIllinois Institute of Technology, Chicago"),
    ("", "anything at all."),
    ("the of and", "Stopwords only; nothing else."),
    ("What score does RAGAS achieve?",
     "Table 1. [ragas_papers#3] ragas 0.95 0.78 0.70; gpt 0.72.\n"
     "Faithfulness is measured. Answer relevance too! Context relevance?"),
]


@pytest.mark.parametrize("query, ctx", CONTEXTS)
def test_extractive_answer_matches_reference(query, ctx):
    assert trd.extractive_answer(query, ctx) == \
        jrd.extractive_answer(query, ctx)
    for text in (query, ctx):
        assert trd._tokens(text) == jrd._tokens(text)
        assert trd._norm(text) == jrd._norm(text)


def test_questions_fixtures_and_dedupe_match_reference():
    assert trd.QUESTIONS == jrd.QUESTIONS
    assert trd.FIXTURES == jrd.FIXTURES
    rng = np.random.default_rng(0)
    words = "alpha beta gamma delta epsilon zeta eta theta".split()
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 9))))
             for _ in range(40)]
    for thresh in (0.3, 0.7, 0.95):
        assert trd._dedupe_texts(texts, thresh) == \
            jrd._dedupe_texts(texts, thresh)


class _FixedEncoder:
    """An embedder stand-in: every text's vector from a table, so both
    packages' proxies see the same scores."""

    def __init__(self, table):
        self.table = table

    def encode(self, texts):
        return np.stack([self.table(t) for t in texts]).astype(np.float32)


def test_retrieval_proxy_duplicate_text_defect_pinned():
    """A duplicated text: the probes of its earlier copy retrieve the
    earlier row top-1 (equal vectors tie toward the lower index), but the
    ``{text: index}`` map wants the last copy, so those probes count as
    misses in both packages — the same grade, below the 1.0 a
    duplicate-free list gets."""
    base = [f"alpha{i} beta{i} gamma{i} delta{i} epsilon{i} zeta{i} "
            f"eta{i} theta{i} iota{i} kappa{i} lambda{i} mu{i} nu{i} "
            f"xi{i} omicron{i} pi{i}" for i in range(6)]
    texts = base + [base[2]]          # one duplicate, last

    def vec(t):
        # every token of chunk i (and of its probes) ends in the digit i:
        # a text's vector is that digit's one-hot
        v = np.zeros(8)
        v[int(t.split()[0][-1])] = 1.0
        return v

    emb = _FixedEncoder(vec)
    got_t = trd._retrieval_proxy(emb, texts)
    got_j = jrd._retrieval_proxy(emb, texts)
    assert got_t == got_j
    assert got_t < 1.0
    assert trd._retrieval_proxy(emb, base) == \
        jrd._retrieval_proxy(emb, base) == 1.0


# ---------------------------------------------------------- real docs stack

@pytest.fixture(scope="module")
def stacks():
    """(JAX stack, port stack on the CPU) over the subset, the port's
    Embedder holding the JAX stack's flax weights."""
    jstack = run(jrd.build_real_docs_stack(files=SUBSET_FILES))
    cfg = Config().encoder
    carried = carried_encoder(jstack.embedder.state.params, cfg)
    real = tembedder.Embedder

    def factory(state_=None, **kw):
        return real(carried if state_ is None else state_, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tembedder, "Embedder", factory)
        tstack = run(trd.build_real_docs_stack(files=SUBSET_FILES))
    return jstack, tstack


def test_real_docs_stack_on_the_embedders_device(stacks):
    _, tstack = stacks
    assert tstack.embedder.device.type == "cpu"
    assert tstack.collection.device.type == "cpu"
    assert tstack.kg.device.type == "cpu"
    assert tstack.collection.cfg.funnel.final_fusion == "dbsf"


def test_real_docs_chunks_match_reference(stacks):
    jstack, tstack = stacks
    # rows follow the pipeline's task completion order (ten workers in
    # both packages), so the texts are compared as multisets
    assert sorted(tstack.chunk_texts) == sorted(jstack.chunk_texts)
    assert tstack.collection.dense.size == jstack.collection.dense.size
    assert set(tstack.ingest_results) == set(jstack.ingest_results)
    assert tstack.kg.stats() == jstack.kg.stats()


def test_real_docs_flags_match_reference(stacks):
    jstack, tstack = stacks
    jres = run(jrd.evaluate_real_docs(jstack, k=5,
                                      questions=SUBSET_QUESTIONS))
    tres = run(trd.evaluate_real_docs(tstack, k=5,
                                      questions=SUBSET_QUESTIONS))
    assert tres["n_questions"] == jres["n_questions"] >= 10
    for jq, tq in zip(jres["per_question"], tres["per_question"]):
        assert (tq["query"], tq["retrieved"], tq["answered"]) == \
            (jq["query"], jq["retrieved"], jq["answered"])
    assert tres["retrieval_recall_at_k"] == jres["retrieval_recall_at_k"]
    assert tres["answer_hit_rate"] == jres["answer_hit_rate"]
    # the reference test's floors hold on the port too
    assert tres["retrieval_recall_at_k"] >= 0.6, tres["per_question"]
    assert tres["answer_hit_rate"] >= 0.2, tres["per_question"]


# -------------------------------------------------------------- multimodal

def _jax_steps(js, scenes, steps, *, batch=16, lr=3e-3, seed=0,
               temperature=0.1, ia_weight=0.25, total=300):
    """The reference's `train_multimodal` loop for ``steps`` of
    ``total`` (its ramp), returning each step's loss and gradient tree
    and the final params. Held to the reference function itself by
    `test_train_multimodal_matches_reference`."""
    model, params = js.state.model, js.state.params
    rng = np.random.default_rng(seed)
    caps = [s.caption for s in scenes]
    ids, mask = js.tokenizer.encode_batch(caps, js.max_len)
    imgs = np.stack([jmm.render_image(s, model.image_size, rng=rng)
                     for s in scenes])
    auds = np.stack([jmm.render_audio(s, rng=rng) for s in scenes])
    zmask = jnp.zeros((batch, ids.shape[1]), dtype=mask.dtype)

    def info_nce(a, b):
        logits = (a @ b.T) / temperature
        labels = jnp.arange(a.shape[0])
        return 0.5 * (
            optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                logits.T, labels).mean())

    def loss_fn(p, b_ids, b_mask, b_imgs, b_auds, ia_w):
        e_t = model.apply(p, b_ids, b_mask)
        e_i = model.apply(p, b_ids, zmask, b_imgs, None, None)
        e_a = model.apply(p, b_ids, zmask, None, None, b_auds)
        return (info_nce(e_t, e_i) + info_nce(e_t, e_a)
                + ia_w * info_nce(e_i, e_a))

    tx = optax.adam(lr)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b_ids, b_mask, b_imgs, b_auds, ia_w):
        loss, grads = jax.value_and_grad(loss_fn)(
            p, b_ids, b_mask, b_imgs, b_auds, ia_w)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, grads

    out = []
    for it in range(steps):
        pick = rng.choice(len(scenes), size=batch, replace=False)
        ia_w = ia_weight * min(1.0, (it + 1) / (0.5 * total))
        params, opt, loss, grads = step(
            params, opt, jnp.asarray(ids[pick]), jnp.asarray(mask[pick]),
            jnp.asarray(imgs[pick]), jnp.asarray(auds[pick]),
            jnp.float32(ia_w))
        out.append((float(loss), jax.tree.map(np.asarray, grads)))
    return out, params


def _mm_pair(seed=0):
    js = j_init(JEncoderConfig(**MM_TINY), multimodal=True, max_len=32,
                seed=seed)
    cfg = EncoderConfig(**MM_TINY)
    ts = carried_encoder(js.params, cfg, multimodal=True)
    return (JEmbedder(cfg=JEncoderConfig(**MM_TINY), state=js, batch_size=4,
                      max_len=32),
            tembedder.Embedder(ts, cfg=cfg, batch_size=4, max_len=32))


@pytest.mark.usefixtures("one_torch_thread")
def test_train_multimodal_matches_reference(monkeypatch):
    """3 steps of the port's `train_multimodal` (``steps=3``: the pair
    term ramps over 1.5 steps) against the reference loop on the same
    batches, step by step; the reference loop against the reference
    function's own weights after 3 steps.

    KEY_BIAS: the attention's key bias adds the same q.b to every logit
    of a row, so its gradient is zero in exact arithmetic and each
    framework's is rounding noise (~1e-10). Adam divides the update by
    |g| + 1e-8, so noise moves it by up to ~lr a step, differently in
    each program: the key bias is left out of the weight comparisons (its
    noise adds nothing to the qkv bias gradient's L2)."""
    steps = 3
    scenes = jmm.all_scenes()[:40]
    jemb, temb = _mm_pair()
    jemb_ref, _ = _mm_pair()
    want, jparams = _jax_steps(jemb, scenes, steps, total=steps)
    # the replica is the reference's loop: the same weights after 3 steps
    # within 1e-5, a thousandth of the 3 lr Adam can move an element in 3
    # steps (the replica's program also returns the gradients, so XLA
    # rounds it a little differently)
    jmm.train_multimodal(jemb_ref, scenes, steps=steps)
    flat_ref = jax.tree_util.tree_flatten_with_path(jemb_ref.state.params)[0]
    for (path, a), b in zip(flat_ref, jax.tree.leaves(jparams)):
        if "'key']['bias']" in jax.tree_util.keystr(path):
            continue  # KEY_BIAS
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-5)

    grads = []
    real_adam = torch.optim.Adam

    class Recorder(real_adam):
        def step(self, closure=None):
            grads.append([p.grad.detach().clone()
                          for g in self.param_groups for p in g["params"]])
            return super().step(closure)

    monkeypatch.setattr(torch.optim, "Adam", Recorder)
    losses = tmm.train_multimodal(temb, [tmm.Scene(**s.__dict__)
                                         for s in scenes], steps=steps)
    names = [n for n, _ in temb.state.model.named_parameters()]
    assert len(losses) == len(grads) == steps
    cfg = EncoderConfig(**MM_TINY)
    for it, ((jloss, jgrad), tloss, tgrad) in enumerate(
            zip(want, losses, grads)):
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        jg = state.encoder_params_from_jax(jgrad, cfg, "cpu")
        for name, g in zip(names, tgrad):
            ref = jg[name].numpy()
            err = np.linalg.norm(g.numpy() - ref)
            scale = max(np.linalg.norm(ref), 1e-12)
            assert err / scale < 1e-4, (it, name, err / scale)
    want_p = state.encoder_params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    h = cfg.hidden_dim
    for name, t in temb.state.model.named_parameters():
        got, ref = t.detach().numpy(), want_p[name].numpy()
        if name.endswith("qkv_b"):
            keep = np.r_[0:h, 2 * h:3 * h]      # KEY_BIAS
            got, ref = got[keep], ref[keep]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.usefixtures("one_torch_thread")
def test_evaluate_multimodal_beats_chance():
    """The reference test's floors at 120 steps on the port (CPU)."""
    _, temb = _mm_pair()
    res = tmm.evaluate_multimodal(steps=120, embedder=temb, seed=0)
    n = res["n_test"]
    assert n >= 30
    chance5 = res["chance_at_5"]
    assert res["text_to_image_recall_at_5"] >= 4 * chance5, res
    assert res["text_to_audio_recall_at_5"] >= 4 * chance5, res
    assert res["image_to_audio_recall_at_5"] >= 2 * chance5, res


def test_multimodal_scenes_and_renderers_match_reference():
    assert [s.caption for s in tmm.all_scenes()] == \
        [s.caption for s in jmm.all_scenes()]
    for s in jmm.all_scenes()[::17]:
        ts = tmm.Scene(**s.__dict__)
        np.testing.assert_array_equal(
            tmm.render_image(ts, 64, rng=np.random.default_rng(1)),
            jmm.render_image(s, 64, rng=np.random.default_rng(1)))
        np.testing.assert_array_equal(
            tmm.render_audio(ts, rng=np.random.default_rng(2)),
            jmm.render_audio(s, rng=np.random.default_rng(2)))
    q = np.random.default_rng(3).standard_normal((12, 8))
    g = q + 0.5 * np.random.default_rng(4).standard_normal((12, 8))
    for k in (1, 3, 5):
        assert tmm._recall_at_k(q, g, k) == jmm._recall_at_k(q, g, k)
