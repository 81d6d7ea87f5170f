"""The BM25 query encode, `SparseIndex.encode_queries`, held to the
per-query loop it replaced (written here as the oracle), on the C
analyzer and on the pure-Python one; the C analyzer's ingest token
streams held to the Python analyzer's and to the JAX package's C copy;
the `bm25_queries_encoded` counter; threads encoding at once."""

import sys
import threading

import numpy as np
import pytest

from benchmark import data
from rag_application_tpu.index.native_analyzer import \
    NativeAnalyzer as JNativeAnalyzer
from rag_application_tpu_torch import native
from rag_application_tpu_torch.config import SparseConfig
from rag_application_tpu_torch.index.analyzer import Analyzer
from rag_application_tpu_torch.index.native_analyzer import NativeAnalyzer
from rag_application_tpu_torch.index.sparse import SparseIndex
from rag_application_tpu_torch.utils import METRICS

LONG_X, LONG_Y = "x" * 100, "y" * 70  # past the C analyzer's 64-byte cap
MANY = [f"t{i}" for i in range(48)]  # more distinct terms than any T

DOCS = [
    "The quick brown fox jumps over the lazy dog.",
    "Foxes run; the dog runs, running dogs ran.",
    "Organizations nationalization happiness hopefully studies.",
    "Tensor processing units accelerate dense retrieval.",
    "café résumé naïve Zürich 東京 fox",
    f"{LONG_X} {LONG_Y}",
    " ".join(MANY),
    "UPPER Case MiXeD 42x x42 2024",
]

QUERIES = {
    "empty_and_unknown": ["", "   ", "?!", "zebra quokka", "fox zebra"],
    "stopwords_only": ["the and of to", "THE is it, with this"],
    "repeated": ["fox fox dog fox", "dog dog dog",
                 "runs running run fox runs"],
    "over_t": [" ".join(MANY), " ".join(MANY[::-1]) + " fox"],
    "stemmed": ["runs running", "organizations nationalization", "foxes"],
    "case_and_bytes": ["FOX Dog LAZY", "café RÉSUMÉ fox", "東京 zürich dog",
                       "fox\x00dog\tlazy\nquick"],
    "long_token": [LONG_X, f"{LONG_Y} fox", f"fox {LONG_X} dog"],
}

# the mixed cell's texts at a small size: zipf documents over "w<id>"
# words, queries a document each with 20% of its words resampled
MIXED = dict(seed=4100000123, vocab=50_000, docs=2048, doc_tokens=24,
             queries=512, flip=0.2)


def mixed_inputs():
    m = MIXED
    tokens = data.synth_tokens(m["seed"], m["docs"], m["vocab"],
                               m["doc_tokens"])
    src = np.arange(m["queries"]) * 3 % m["docs"]
    qtok = data.noisy_tokens(tokens, src, m["seed"], m["flip"], m["vocab"])
    return tokens, data.texts(qtok)


def make(kind: str):
    return NativeAnalyzer() if kind == "native" else Analyzer()


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("no C compiler to build the native analyzer")
    tokens, texts = mixed_inputs()
    queries = dict(QUERIES, mixed=texts)
    cache = {}

    def index(case: str, kind: str, t: int) -> SparseIndex:
        key = (case, kind, t)
        if key not in cache:
            sp = SparseIndex(SparseConfig(max_query_terms=t),
                             analyzer=make(kind), device="cpu")
            if case == "mixed":
                sp.analyzer.vocab = {f"w{i}": i
                                     for i in range(MIXED["vocab"])}
                sp.add_pretokenized(tokens)
            else:
                for doc in DOCS:
                    sp.add(doc)
            sp.rebuild()
            cache[key] = sp
        return cache[key]

    return index, queries


def old_loop(analyzer, queries, t, v_pad):
    """`encode_queries`' arrays as the per-query loop built them."""
    n = len(queries)
    q_rows = np.full((n, t), v_pad - 1, dtype=np.int32)
    q_terms = np.full((n, t), -2, dtype=np.int32)
    q_valid = np.zeros((n, t), dtype=bool)
    encode_batch = getattr(analyzer, "encode_batch", None)
    if encode_batch is not None:
        flat, offsets = encode_batch(queries, grow=False)
        for i in range(n):
            seg = flat[offsets[i]:offsets[i + 1]]
            if seg.size:
                _, first = np.unique(seg, return_index=True)
                seg = seg[np.sort(first)][:t]
            m = len(seg)
            q_rows[i, :m] = seg
            q_terms[i, :m] = seg
            q_valid[i, :m] = True
    else:
        for i, qtext in enumerate(queries):
            tids = list(dict.fromkeys(analyzer.encode(qtext, grow=False)))[:t]
            for j, tid in enumerate(tids):
                q_rows[i, j] = tid
                q_terms[i, j] = tid
                q_valid[i, j] = True
    return q_rows, q_terms, q_valid


def encoded(sp, queries):
    return [a.numpy() for a in sp.encode_queries(queries)]


def assert_same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


CASES = sorted(QUERIES) + ["mixed"]


@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("kind", ["native", "python"])
@pytest.mark.parametrize("case", CASES)
def test_encode_queries_matches_the_loop(built, case, kind, t):
    index, queries = built
    sp = index(case, kind, t)
    size = len(sp.analyzer)
    got = encoded(sp, queries[case])
    assert_same(got, old_loop(sp.analyzer, queries[case], t,
                              sp.device_arrays()["v_pad"]))
    assert len(sp.analyzer) == size  # queries never grow the vocabulary


@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("case", CASES)
def test_native_and_python_give_the_same_arrays(built, case, t):
    index, queries = built
    assert_same(encoded(index(case, "native", t), queries[case]),
                encoded(index(case, "python", t), queries[case]))


@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("kind", ["native", "python"])
def test_terms_after_the_t_th_do_not_matter(built, kind, t):
    index, _ = built
    sp = index("over_t", kind, t)
    first = " ".join(MANY[:t])
    rows = encoded(sp, [first, f"{first} fox dog", f"{first} {first} lazy"])
    for a in rows:
        assert (a[1:] == a[0]).all()
    assert rows[2].all()  # every slot holds a term


def test_native_query_tokens_are_cut_at_64_bytes(built):
    """The C analyzer keeps a token's first 64 bytes, at ingest and in
    queries alike: 65 x's find the 100-x document term."""
    index, _ = built
    q_rows, _, q_valid = encoded(index("long_token", "native", 32),
                                 [LONG_X, "x" * 65, "x" * 63])
    assert q_valid[:2, 0].all() and q_rows[1, 0] == q_rows[0, 0]
    assert not q_valid[2].any()


# ------------------------------------------------- ingest token streams

def ingest_texts():
    """Seeded documents: words with suffixes, stopwords, digits, mixed
    case, punctuation and non-ASCII bytes, some tokens past 64 bytes."""
    rng = np.random.default_rng(23)
    words = ["retrieval", "nationalization", "happiness", "studies",
             "studied", "running", "runs", "fox", "Boxes", "the", "AND",
             "with", "their", "these", "it", "no", "such", "a1", "x42",
             "2024", "café", "naïve", "東京", "ITEMS", "carefully",
             "operational", "ousness", "ing", "ies", "s"]
    seps = [" ", "  ", ", ", ".", "-", "\t", "\n", "/", "é", "—", "\x00"]
    out = list(DOCS)
    for _ in range(300):
        parts = []
        for _ in range(int(rng.integers(0, 40))):
            if rng.random() < 0.02:
                parts.append("k" * int(rng.integers(60, 90)))
            else:
                parts.append(words[int(rng.integers(len(words)))])
            parts.append(seps[int(rng.integers(len(seps)))])
        out.append("".join(parts))
    return out


def has_long_token(text: str) -> bool:
    return any(len(tok) > 64 for tok in Analyzer().tokenize(text))


@pytest.mark.parametrize("how", ["encode", "encode_batch"])
@pytest.mark.parametrize("reference", ["python", "jax_native"])
def test_native_ingest_streams_match(reference, how):
    """Growing the vocabulary over ingest text gives the reference's ids
    term for term. The Python analyzer keeps tokens past 64 bytes whole,
    so it is held only to texts without one."""
    if not native.available():
        pytest.skip("no C compiler to build the native analyzer")
    texts = ingest_texts()
    if reference == "python":
        texts = [t for t in texts if not has_long_token(t)]
        ref = Analyzer()
    else:
        ref = JNativeAnalyzer()
    want = [ref.encode(t, grow=True) for t in texts]
    nat = NativeAnalyzer()
    if how == "encode":
        got = [nat.encode(t, grow=True) for t in texts]
    else:
        flat, offsets = nat.encode_batch(texts, grow=True)
        got = [flat[offsets[i]:offsets[i + 1]].tolist()
               for i in range(len(texts))]
    assert got == want
    assert len(nat) == len(ref)
    # and the grown vocabulary reads back the same for queries
    assert nat.encode(" ".join(texts[:50]), grow=False) == ref.encode(
        " ".join(texts[:50]), grow=False)


# ------------------------------------------------ the counter, threads

def counter(path: str) -> float:
    head = f'bm25_queries_encoded_total{{path="{path}"}} '
    for line in METRICS.render().splitlines():
        if line.startswith(head):
            return float(line[len(head):])
    return 0.0


@pytest.mark.parametrize("kind", ["native", "python"])
def test_counter_names_the_path(built, kind):
    index, queries = built
    other = "python" if kind == "native" else "native"
    before = counter(kind), counter(other)
    index("repeated", kind, 32).encode_queries(queries["repeated"])
    assert counter(kind) - before[0] == len(queries["repeated"])
    assert counter(other) == before[1]


def test_threads_encode_at_once(built):
    """Threads encoding one batch at once through one native index each
    get the single-thread arrays, and none grows the vocabulary."""
    index, queries = built
    sp = index("mixed", "native", 32)
    want = encoded(sp, queries["mixed"])
    size = len(sp.analyzer)
    n_threads, rounds = 4, 8
    barrier = threading.Barrier(n_threads)
    bad, done = [], []

    def work():
        try:
            barrier.wait(timeout=30)
            for _ in range(rounds):
                got = encoded(sp, queries["mixed"])
                if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                    bad.append("arrays differ")
            done.append(1)
        except Exception as e:  # reported below, with the thread's arrays
            bad.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not bad and len(done) == n_threads
    assert len(sp.analyzer) == size
