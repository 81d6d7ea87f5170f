"""Contrastive training data from the indexed corpus.

Copy of `rag_application_tpu/models/train_data.py` (numpy and the
standard library only), over the port's `store.collection.Collection`
and `models.tokenizer.HashTokenizer`. With the same numpy generator the
pair builders and `batches` give the reference's outputs.

The reference cannot improve its embeddings (they come from remote
services); this framework fine-tunes its encoder on the user's own
corpus. Standard recipes, no external data:

  * neighbor pairs — adjacent chunks of the same document are positives
    (local coherence), in-batch negatives for everything else;
  * self-supervised cropping — two random word-windows of one chunk;
  * optional LLM query generation — synthesize a query per chunk and
    train (query, chunk) pairs (the "GPL-style" recipe), via any
    LLMRouter.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..store.collection import Collection
from .tokenizer import HashTokenizer


def neighbor_pairs(collection: Collection) -> List[Tuple[str, str]]:
    """(chunk_i, chunk_{i+1}) pairs within each document."""
    by_doc: dict = {}
    for row in range(len(collection.payloads)):
        p = collection.payloads.get(row)
        if p is None or not p.get("text"):
            continue
        by_doc.setdefault(p.get("document_id"), []).append(
            (p.get("chunk_index", row), p["text"]))
    pairs = []
    for chunks in by_doc.values():
        chunks.sort()
        for (_, a), (_, b) in zip(chunks, chunks[1:]):
            pairs.append((a, b))
    return pairs


def crop_pairs(texts: Sequence[str], rng: np.random.Generator,
               *, min_words: int = 8) -> List[Tuple[str, str]]:
    """Two random word-windows per text (SimCSE-style views)."""
    pairs = []
    for t in texts:
        words = t.split()
        if len(words) < 2 * min_words:
            continue
        half = len(words) // 2
        w = max(min_words, half // 2)
        s1 = rng.integers(0, max(1, half - w))
        s2 = rng.integers(half, max(half + 1, len(words) - w))
        pairs.append((" ".join(words[s1:s1 + w]),
                      " ".join(words[s2:s2 + w])))
    return pairs


def ict_pairs(texts: Sequence[str], rng: np.random.Generator,
              *, min_words: int = 16,
              max_query_words: int = 24) -> List[Tuple[str, str]]:
    """Inverse Cloze Task pairs (Lee et al. 2019): pseudo-query = one
    sentence, positive = its passage WITH THE SENTENCE REMOVED (90%) or
    kept (10%, so the model still scores lexical overlap). Unlike
    crop_pairs' symmetric views, this trains the asymmetric
    question->passage geometry retrieval actually serves — the offline
    analogue of the reference's pretrained query encoders."""
    import re

    pairs = []
    for t in texts:
        if len(t.split()) < min_words:
            continue
        sents = [s.strip() for s in re.split(r"(?<=[.!?;])\s+|\n+", t)
                 if len(s.strip().split()) >= 3]
        if len(sents) < 2:
            continue
        i = int(rng.integers(0, len(sents)))
        q_words = sents[i].split()[:max_query_words]
        if rng.random() < 0.9:
            ctx = " ".join(sents[:i] + sents[i + 1:])
        else:
            ctx = " ".join(sents)
        if not ctx.split():
            continue
        pairs.append((" ".join(q_words), ctx))
    return pairs


def keyword_pairs(texts: Sequence[str], rng: np.random.Generator,
                  *, per_text: int = 2, min_terms: int = 3,
                  max_terms: int = 7) -> List[Tuple[str, str]]:
    """Keyword-probe pairs: pseudo-query = a handful of the text's
    high-IDF tokens (shuffled), positive = the text. The LLM-free
    analogue of doc2query/GPL query generation: real users ask
    keyword-anchored questions ("pokemon stats sheet columns"), and
    small-corpus InfoNCE on crops/ICT alone learns to DOWN-weight
    exactly those cross-chunk anchor tokens (they repeat across a
    document's chunks), measurably degrading question retrieval
    (evals/real_docs.py r5 analysis). These pairs teach the encoder to
    route rare anchors to their chunk — no needle/test leakage, IDF is
    a corpus statistic."""
    df: dict = {}
    tok_lists = []
    for t in texts:
        toks = [w for w in t.lower().split() if len(w) >= 3]
        tok_lists.append(toks)
        for w in set(toks):
            df[w] = df.get(w, 0) + 1
    n = max(len(texts), 1)
    pairs = []
    for t, toks in zip(texts, tok_lists):
        uniq = list(dict.fromkeys(toks))
        if len(uniq) < min_terms:
            continue
        idf = np.array([np.log(n / df[w]) + 0.1 for w in uniq])
        p = idf / idf.sum()
        for _ in range(per_text):
            k = int(rng.integers(min_terms, max_terms + 1))
            k = min(k, len(uniq))
            pick = rng.choice(len(uniq), size=k, replace=False, p=p)
            pairs.append((" ".join(uniq[i] for i in pick), t))
    return pairs


async def llm_query_pairs(texts: Sequence[str], llm,
                          *, max_pairs: int = 256) -> List[Tuple[str, str]]:
    """Synthesize a search query per chunk (query, chunk) — GPL recipe."""
    pairs = []
    for t in texts[:max_pairs]:
        q = await llm.generate_text(
            f"Write one short search query this passage answers:\n{t[:1200]}",
            system="You write search queries.")
        if q.strip():
            pairs.append((q.strip(), t))
    return pairs


def batches(
    pairs: Sequence[Tuple[str, str]],
    tokenizer: HashTokenizer,
    *,
    batch_size: int = 64,
    max_len: int = 128,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """Shuffled epochs of tokenized contrastive batches for
    models.train.make_train_step."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_remainder:
            return
        a = [pairs[i][0] for i in idx]
        b = [pairs[i][1] for i in idx]
        ids_a, mask_a = tokenizer.encode_batch(a, max_len)
        ids_b, mask_b = tokenizer.encode_batch(b, max_len)
        yield {"ids_a": ids_a, "mask_a": mask_a,
               "ids_b": ids_b, "mask_b": mask_b}
