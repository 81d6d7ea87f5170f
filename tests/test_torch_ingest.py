"""The ingest pipeline (`ingest/pipeline.py`) against the JAX reference's,
on the CPU.

Both packages run the same `IngestPipeline` calls on the same bytes, with
the same encoder weights (the flax encoder carried over by
`state.encoder_params_from_jax`, f32 config), a `KGStore` each and the
tests/test_ingest.py extractor. The cases are those of
tests/test_ingest.py, the pipeline cases of tests/test_object_store.py
and tests/test_filetype.py, and documents: the fixtures, the real ones
and a PDF built in code.

What must agree:
- the `IngestResult`s, and the failed ledgers error for error;
- at `max_concurrency=1`, every write in order: the payloads of each
  `store_document_vectors` and KG upsert exactly, their embeddings
  within atol 1e-5; the payload tables row for row; the dense tables
  within the insert parity bounds of tests/test_torch_prep.py (bf16
  within one ulp, int8 within one step); the KG's host state and
  `stats()`;
- at the default concurrency, where row ids depend on which worker
  finishes first in either package, the same, keyed by (document_id,
  page_number or chunk_index);
- after the reference's dense tables are carried over with
  `state.dense_from_numpy`, `hybrid_search` gives equal rows and
  payloads, scores within rtol 1e-5.
"""

import asyncio
import dataclasses
import functools
import math
import os
import struct

import jax
import numpy as np
import pytest
import torch

from fixtures.make_fixtures import build_docx, build_pdf, text_page
from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import IngestConfig as JIngestConfig
from rag_application_tpu.config import KGConfig as JKGConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.ingest.pipeline import IngestPipeline as JPipeline
from rag_application_tpu.ingest.queue import \
    NonRetryableError as JNonRetryableError
from rag_application_tpu.ingest.queue import Task as JTask
from rag_application_tpu.ingest.queue import TaskType as JTaskType
from rag_application_tpu.ingest.queue import WorkQueue as JWorkQueue
from rag_application_tpu.kg.store import KGStore as JKGStore
from rag_application_tpu.kg.store import Space as JSpace
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu.store.objects import ObjectStore as JObjectStore
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import Config, EncoderConfig
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import IngestConfig, KGConfig
from rag_application_tpu_torch.config import SparseConfig
from rag_application_tpu_torch.ingest.pipeline import IngestPipeline
from rag_application_tpu_torch.ingest.queue import NonRetryableError
from rag_application_tpu_torch.ingest.queue import Task, TaskType, WorkQueue
from rag_application_tpu_torch.kg.store import KGStore, Space
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.encoder import init_encoder
from rag_application_tpu_torch.store.collection import Collection
from rag_application_tpu_torch.store.objects import ObjectStore

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DIM = 32
ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=32, out_dim=DIM, dtype="float32")


def small_config(cls, index, sparse, funnel):
    """tests/test_ingest.py's collection config, in either package."""
    cfg = cls()
    cfg.index = index(dim=DIM, matryoshka_dims=(8, 16), initial_capacity=16)
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    return cfg


@functools.lru_cache(maxsize=None)
def embedders(multimodal=False):
    """(JAX Embedder, port Embedder) on the same encoder weights: the text
    tower, or with ``multimodal`` the multimodal one (tests/test_audio.py's
    TINY_MM widths)."""
    js = j_init(JEncoderConfig(**ECFG), max_len=32, seed=11,
                multimodal=multimodal)
    cfg = EncoderConfig(**ECFG)
    ts = init_encoder(cfg, device="cpu", multimodal=multimodal)
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return (JEmbedder(js, batch_size=4, max_len=32),
            Embedder(ts, batch_size=4, max_len=32))


def extractor(text):
    """tests/test_ingest.py's KG extractor."""
    if "vivek" in text.lower():
        return {
            "entities": [
                {"id": "vivek", "text": "Vivek", "entity_type": "PERSON",
                 "entity_profile": "author"}],
            "relationships": [],
        }
    return {"entities": [], "relationships": []}


def graph_extractor(text):
    """Entities and a relationship on every page that names retrieval."""
    if "retrieval" not in text.lower():
        return {"entities": [], "relationships": []}
    ents = [{"id": n, "text": n.title(), "entity_type": t,
             "entity_profile": f"{n} profile"}
            for n, t in (("retrieval", "CONCEPT"), ("engine", "PRODUCT"),
                         ("vivek", "PERSON"))]
    rels = [{"source": "vivek", "target": "engine", "relation_type": "CREATED",
             "relationship_profile": "vivek built the engine"},
            {"source": "engine", "target": "retrieval",
             "relation_type": "USES",
             "relationship_profile": "the engine does retrieval"}]
    return {"entities": ents, "relationships": rels}


class Contextualizer:
    """A stub async LLM: one summary, then a context naming its chunk."""

    async def generate_text(self, prompt, system=None):
        if prompt.startswith("Summarize this document"):
            return "a doc about retrieval"
        return "context: " + prompt.split("Target chunk:\n", 1)[1][:24]


def describer(image):
    return f"a picture of {len(image)} bytes"


def canon(obj, arrays):
    """``obj`` with its numpy arrays moved into ``arrays`` (f32), numpy
    scalars as Python ones and NaN as a string: comparable with ==."""
    if isinstance(obj, np.ndarray):
        arrays.append(np.asarray(obj, np.float32))
        return ("array", obj.shape)
    if isinstance(obj, dict):
        return {canon(k, arrays): canon(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [canon(v, arrays) for v in obj]
    if isinstance(obj, tuple):
        return tuple(canon(v, arrays) for v in obj)
    if isinstance(obj, set):
        return sorted(map(repr, obj))
    if isinstance(obj, np.generic):
        return canon(obj.item(), arrays)
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    return obj


def chunk_key(p):
    """(document_id, page_number or chunk_index) of a chunk's payload (a
    page's chunk is stored with chunk_index 0 as well)."""
    return (p["document_id"], p.get("page_number", p.get("chunk_index")))


def write_key(name, args):
    """The key of a recorded write: its chunk's, or its KG page's."""
    if name == "store_document_vectors":
        return chunk_key({"document_id": args[0], **args[1][0]})
    return (args[0], args[1])


def record(obj, names, log):
    """Record every call of ``obj``'s methods ``names`` into ``log``."""
    for name in names:
        fn = getattr(obj, name)

        def rec(*args, _fn=fn, _name=name, **kwargs):
            log.append((_name, args, kwargs))
            return _fn(*args, **kwargs)

        setattr(obj, name, rec)


def dense_arrays(j):
    def np_or_none(a):
        return None if a is None else np.asarray(a)
    return {"vecs": np.asarray(j.vecs).view(np.uint16),
            "int8": np_or_none(j.int8), "inv_norms": np.asarray(j.inv_norms),
            "int8_recip": np_or_none(j.int8_recip),
            "live": np.asarray(j.live),
            "prefix_int8": np_or_none(j.prefix_int8)}


def assert_rows_close(jidx, tidx, jrows, trows):
    """Dense rows within the prep pass's rounding: bf16 one ulp, int8 one
    step, inverse norms rtol 1e-6, live flags equal."""
    jrows, trows = np.asarray(jrows, np.int64), np.asarray(trows, np.int64)
    ref = np.asarray(jidx.vecs).view(np.uint16)[jrows].astype(np.int32)
    bits = tidx.vecs.view(torch.int16).numpy().view(np.uint16)[trows]
    assert np.abs(bits.astype(np.int32) - ref).max(initial=0) <= 1
    if jidx.int8 is not None:
        assert np.abs(tidx.int8.numpy()[trows].astype(np.int32)
                      - np.asarray(jidx.int8)[jrows].astype(np.int32)
                      ).max(initial=0) <= 1
    np.testing.assert_allclose(tidx.inv_norms.numpy()[trows],
                               np.asarray(jidx.inv_norms)[jrows], rtol=1e-6)
    np.testing.assert_array_equal(tidx.live.numpy()[trows],
                                  np.asarray(jidx.live)[jrows])


def kg_host_state(kg):
    tables = {s.value: (t.payloads, t.by_key,
                        {k: dict(v) for k, v in t.by_id.items()},
                        t.index.size)
              for s, t in kg.spaces.items()}
    return (kg.documents, kg.doc_pages, kg.entity_edges, kg.page_mentions,
            kg.column_values, kg.page_columns, tables)


class Pair:
    """One `IngestPipeline` in each package, built alike, recording each
    side's writes."""

    def __init__(self, root=None, *, concurrency=1, kg=True,
                 kg_extractor=extractor, multimodal=False, **hooks):
        je, te = self.embedders = embedders(multimodal)
        self.concurrency = concurrency
        self.jcol = JCollection("t", small_config(
            JConfig, JIndexConfig, JSparseConfig, JFunnelConfig))
        self.tcol = Collection("t", small_config(
            Config, IndexConfig, SparseConfig, FunnelConfig), device="cpu")
        self.jkg = JKGStore(JKGConfig(max_degree=8), dim=DIM) if kg else None
        self.tkg = (KGStore(KGConfig(max_degree=8), dim=DIM, device="cpu")
                    if kg else None)
        self.jstore = self.tstore = None
        if root is not None:
            self.jstore = JObjectStore(root / "jax")
            self.tstore = ObjectStore(root / "port")
        self.jlog, self.tlog = [], []
        for col, kgs, log in ((self.jcol, self.jkg, self.jlog),
                              (self.tcol, self.tkg, self.tlog)):
            record(col, ["store_document_vectors"], log)
            if kgs is not None:
                record(kgs, ["upsert_unstructured_page",
                             "upsert_structured_sheet"], log)
        extract = kg_extractor if kg else None
        self.j = JPipeline(
            self.jcol, je, kg=self.jkg, kg_extractor=extract,
            object_store=self.jstore, config=JIngestConfig(
                chunk_chars=200, max_concurrency=concurrency), **hooks)
        self.t = IngestPipeline(
            self.tcol, te, kg=self.tkg, kg_extractor=extract,
            object_store=self.tstore, config=IngestConfig(
                chunk_chars=200, max_concurrency=concurrency), **hooks)

    def run(self, method, *args, **kwargs):
        """The same call on both pipelines; the results must be equal."""
        jr = asyncio.run(getattr(self.j, method)(*args, **kwargs))
        tr = asyncio.run(getattr(self.t, method)(*args, **kwargs))
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        return tr

    def failed(self):
        return ([(t.task_type.value, t.attempts, t.error)
                 for t in self.j.queue.failed],
                [(t.task_type.value, t.attempts, t.error)
                 for t in self.t.queue.failed])

    def check(self, query=None):
        """Everything the two sides wrote, as the module docstring says."""
        jf, tf = self.failed()
        assert tf == jf
        assert ([s["task_type"] for s in self.t.queue.succeeded]
                == [s["task_type"] for s in self.j.queue.succeeded]
                or self.concurrency > 1)
        assert len(self.t.queue.succeeded) == len(self.j.queue.succeeded)
        jp, tp = self.jcol.payloads._payloads, self.tcol.payloads._payloads
        assert len(tp) == len(jp)
        assert self.tcol.chunk_count() == self.jcol.chunk_count()
        if self.concurrency == 1:
            self._check_in_order(jp, tp)
        else:
            self._check_keyed(jp, tp)
        if self.jkg is not None:
            assert self.tkg.stats() == self.jkg.stats()
        if query is not None:
            self._check_search(query)

    def _check_writes(self, jw, tw):
        ja, ta = [], []
        assert canon(tw, ta) == canon(jw, ja)
        assert len(ta) == len(ja)
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

    def _check_in_order(self, jp, tp):
        self._check_writes(self.jlog, self.tlog)
        assert canon(tp, []) == canon(jp, [])
        assert_rows_close(self.jcol.dense, self.tcol.dense,
                          np.arange(len(jp)), np.arange(len(tp)))
        if self.jkg is not None:
            assert canon(kg_host_state(self.tkg), []) == canon(
                kg_host_state(self.jkg), [])
            for s in Space:
                jt = self.jkg.spaces[JSpace(s.value)].index
                n = jt.size
                assert self.tkg.spaces[s].index.size == n
                assert_rows_close(jt, self.tkg.spaces[s].index,
                                  np.arange(n), np.arange(n))

    def _check_keyed(self, jp, tp):
        def by_key(log):
            return {(name, write_key(name, args)): (args, kwargs)
                    for name, args, kwargs in log}

        jw, tw = by_key(self.jlog), by_key(self.tlog)
        assert len(jw) == len(self.jlog) and len(tw) == len(self.tlog)
        assert sorted(tw) == sorted(jw)
        self._check_writes([jw[k] for k in sorted(jw)],
                           [tw[k] for k in sorted(jw)])

        def live(payloads):
            out = {chunk_key(p): (r, p)
                   for r, p in enumerate(payloads) if p is not None}
            assert len(out) == sum(p is not None for p in payloads)
            return out

        jl, tl = live(jp), live(tp)
        assert sorted(tl) == sorted(jl)
        assert all(canon(tl[k][1], []) == canon(jl[k][1], []) for k in jl)
        keys = sorted(jl)
        assert_rows_close(self.jcol.dense, self.tcol.dense,
                          [jl[k][0] for k in keys], [tl[k][0] for k in keys])
        if self.jkg is not None:
            for s in Space:
                jt = self.jkg.spaces[JSpace(s.value)]
                tt = self.tkg.spaces[s]
                assert sorted(map(repr, tt.by_key)) == sorted(
                    map(repr, jt.by_key))

    def _check_search(self, query):
        """Carry the reference's dense tables over, then search both: a
        text query, or an (image raster, caption) or (log-mel, caption)
        query through the multimodal tower."""
        je, _ = self.embedders
        if isinstance(query, tuple):
            media, query = query
            fn = je.encode_image if media.shape[-1] == 3 else je.encode_audio
            q = fn(media, texts=[query])[0]
        else:
            q = je.encode([query])[0]
        j = self.jcol.dense
        self.tcol.dense = state.dense_from_numpy(
            self.tcol.cfg.index, dense_arrays(j), j.size, j.has_deletes,
            device="cpu")
        self.tcol._fused.dense = self.tcol.dense
        jh = self.jcol.hybrid_search(q, query, limit=5, adaptive=False)
        th = self.tcol.hybrid_search(q, query, limit=5, adaptive=False)
        assert jh
        assert [h.row for h in th] == [h.row for h in jh]
        np.testing.assert_allclose([h.score for h in th],
                                   [h.score for h in jh], rtol=1e-5)
        assert [h.payload for h in th] == [h.payload for h in jh]


def read(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


# ---------------------------------------------------------- tests/test_ingest

@pytest.mark.parametrize("concurrency", [1, 4])
def test_text(concurrency):
    pair = Pair(concurrency=concurrency)
    res = pair.run("ingest_text", "Vivek built a retrieval system. " * 20,
                   document_id="doc1")
    assert res.chunks >= 2 and res.failed_tasks == 0
    assert any(e["id"] == "vivek" for e in pair.tkg.get_entities("doc1"))
    pair.check("retrieval system" if concurrency == 1 else None)


@pytest.mark.parametrize("concurrency", [1, 4])
def test_text_with_relationships(concurrency):
    pair = Pair(concurrency=concurrency, kg_extractor=graph_extractor)
    pair.run("ingest_text", "Vivek built a retrieval engine. " * 30,
             document_id="doc1")
    pair.run("ingest_text", "the engine answers retrieval queries. " * 12,
             document_id="doc2")
    assert pair.tkg.stats()["relationship"] > 0
    pair.check()


@pytest.mark.parametrize("name", ["people.csv", "Pokemon.csv"])
def test_csv(name):
    data = (read("real", name) if name == "Pokemon.csv"
            else b"name,age\nalice,30\nbob,25\n")
    pair = Pair()
    res = pair.run("ingest_file", name, data, document_id="sheet1")
    assert res.chunks == 1
    assert pair.tkg.stats()["column"] == (13 if name == "Pokemon.csv" else 2)
    pair.check()


def test_reingest():
    pair = Pair()
    text = "some document text here " * 30
    pair.run("ingest_text", text, document_id="dup")
    first = pair.tcol.chunk_count(), pair.tkg.stats()
    pair.run("ingest_text", text, document_id="dup")
    assert (pair.tcol.chunk_count(), pair.tkg.stats()) == first
    pair.check("document text")


def test_empty_csv():
    pair = Pair()
    res = pair.run("ingest_file", "empty.csv", b"", document_id="e1")
    assert res.chunks == 0 and res.failed_tasks == 1
    assert pair.t.queue.failed[0].attempts == 0
    pair.check()


def test_contextualized():
    pair = Pair(contextualizer=Contextualizer())
    res = pair.run("ingest_text", "retrieval systems need context. " * 40,
                   document_id="ctxdoc")
    assert res.chunks >= 2
    rows = pair.tcol.payloads.rows_where(document_id="ctxdoc")
    assert pair.tcol.payloads.get(rows[0])["context"].startswith("context: ")
    pair.check("retrieval context")


@pytest.mark.parametrize("with_describer", [False, True])
def test_image(with_describer):
    hooks = {"page_describer": describer} if with_describer else {}
    pair = Pair(**hooks)
    res = pair.run("ingest_file", "pic.png", b"\x89PNG...", document_id="img")
    assert res.chunks == (1 if with_describer else 0)
    if not with_describer:
        assert "page_describer" in pair.t.queue.failed[-1].error
    pair.check()


def wav_bytes():
    pcm = np.zeros(800, np.int16).tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 16000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def avi_bytes():
    from test_video import build_avi, jpeg_blob

    return build_avi([jpeg_blob(i) for i in range(3)])


@pytest.mark.parametrize("name", ["clip.wav", "song.mp3", "tour.avi"])
def test_media_fails_into_ledger(name):
    """With a text tower, audio and (without a describer) video fail with
    the reference's messages."""
    data = {"clip.wav": wav_bytes, "song.mp3": lambda: b"\xff\xfbbinary",
            "tour.avi": avi_bytes}[name]()
    pair = Pair()
    res = pair.run("ingest_file", name, data, document_id="m")
    assert res.chunks == 0 and res.failed_tasks == 1
    assert "no processor for media file" in pair.t.queue.failed[-1].error
    pair.check()


# ------------------------- tests/test_{image,jpeg,audio,flac,video}.py media

def smooth(h, w, shade=1.0):
    yy, xx = np.mgrid[0:h, 0:w]
    return shade * np.stack([0.5 + 0.5 * np.sin(xx / 17.0),
                             0.5 + 0.5 * np.cos(yy / 13.0),
                             np.clip((xx + yy) / (h + w), 0, 1)],
                            axis=-1).astype(np.float32)


def png_bytes(seed=0, h=40, w=56):
    from rag_application_tpu_torch.ingest.pdf import _make_png

    rgb = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    return _make_png(rgb.tobytes(), w, h, 8, "rgb")


def jpeg_bytes(shade=1.0, h=48, w=64):
    from rag_application_tpu_torch.models.jpeg import encode_jpeg

    return encode_jpeg(smooth(h, w, shade), quality=90)


def tone(freq=440.0, seconds=0.5):
    from test_audio import make_wav

    return make_wav(freq=freq, seconds=seconds)


def flac_bytes(seed=5):
    from test_flac import _sig

    from rag_application_tpu_torch.ingest.flac import encode_flac

    return encode_flac(_sig(12000, 2, 16, seed=seed), 16000)


def mjpeg_avi(n=3):
    from test_video import build_avi

    return build_avi([jpeg_bytes(0.3 + 0.2 * i, 24, 32) for i in range(n)])


def scanned_pdf():
    """tests/test_pdf.py's scanned page: one DCTDecode image, no text."""
    from test_pdf import build_image_pdf

    jpeg = jpeg_bytes(h=60, w=80)
    return build_image_pdf(
        b"<< /Type /XObject /Subtype /Image /Width 80 /Height 60 "
        b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode "
        b"/Length %d >>" % len(jpeg), jpeg)


MEDIA = {
    "pic.png": (png_bytes, 1),
    "photo.jpg": (jpeg_bytes, 1),
    "clip.wav": (tone, 1),
    "clip.flac": (flac_bytes, 1),
    "song.mp3": (lambda: b"\xff\xfbbinary", 0),
    "tour.avi": (mjpeg_avi, 3),
    "scan.pdf": (scanned_pdf, 0),
    "broken.png": (lambda: b"\x89PNG...", 0),
}


@pytest.mark.parametrize("name", list(MEDIA))
def test_media_multimodal(name):
    """With a multimodal tower and no describer, each file becomes the
    reference's chunks (an MP3 without a decoder, an undecodable PNG and
    an image-only PDF, which needs a describer, fail with its messages)."""
    make, chunks = MEDIA[name]
    pair = Pair(multimodal=True)
    res = pair.run("ingest_file", name, make(), document_id="m")
    assert res.chunks == chunks and res.failed_tasks == (chunks == 0)
    pair.check()


def test_media_multimodal_search():
    """An image, a photo and two tones, then the reference's search with
    an image query (a stored raster and its caption) on both sides."""
    from rag_application_tpu_torch.models.image import image_to_input

    pair = Pair(multimodal=True, kg=False)
    for name, data in (("a.png", png_bytes(1)), ("b.jpg", jpeg_bytes(0.7)),
                       ("low.wav", tone(300)), ("high.wav", tone(2500))):
        pair.run("ingest_file", name, data, document_id=name)
    pair.check((image_to_input(png_bytes(1), 224)[None], "[image] page 1"))


def test_audio_transcriber_and_decoder():
    """tests/test_audio.py's hooks: a transcript becomes the chunk's text
    (and its KG page); a decoder hook opens an MP3."""
    pair = Pair(multimodal=True, audio_transcriber=lambda data: (
        "Vivek's meeting about quarterly revenue"))
    res = pair.run("ingest_file", "meeting.wav", tone(), document_id="mt")
    assert res.failed_tasks == 0 and res.chunks == 1
    row = pair.tcol.payloads.rows_where(document_id="mt")[0]
    assert "quarterly revenue" in pair.tcol.payloads.get(row)["text"]
    assert pair.tkg.stats()["entity"] == 1
    pair.check()
    pair = Pair(multimodal=True, audio_decoder=lambda data: (
        np.sin(np.linspace(0, 600 * np.pi, 24000)).astype(np.float32), 24000))
    res = pair.run("ingest_file", "clip.mp3", b"\xff\xfbFAKEMP3DATA",
                   document_id="mp3")
    assert res.failed_tasks == 0 and res.chunks == 1
    pair.check()


def test_media_concurrent():
    """Every media kind at the default concurrency: keyed writes, payloads
    and tables agree, and the queues' counts and the KG's `stats()` too."""
    pair = Pair(concurrency=IngestConfig().max_concurrency, multimodal=True)
    for name, (make, _) in MEDIA.items():
        pair.run("ingest_file", name, make(), document_id=name)
    pair.run("ingest_text", "Vivek built a retrieval engine. " * 10,
             document_id="notes")
    assert pair.t.queue.queue_info() == pair.j.queue.queue_info()
    pair.check()


def test_video_with_describer():
    pair = Pair(page_describer=describer)
    res = pair.run("ingest_file", "tour.avi", avi_bytes(), document_id="v")
    assert res.chunks == 3 and res.failed_tasks == 0
    pair.check()


@pytest.mark.parametrize("with_fetcher", [False, True])
def test_url(with_fetcher):
    async def fetcher(url):
        assert url == "https://example.com/docs/page"
        return ("<html><head><script>x()</script></head><body>"
                "<h1>Retrieval</h1><p>" + "engine facts. " * 40
                + "</p></body></html>")

    pair = Pair(kg=False, **({"url_fetcher": fetcher} if with_fetcher else {}))
    res = pair.run("ingest_url", "https://example.com/docs/page")
    assert res.failed_tasks == (0 if with_fetcher else 1)
    assert (res.chunks >= 1) == with_fetcher
    pair.check("engine facts" if with_fetcher else None)


def test_failed_tasks_count_current_ingest_only():
    pair = Pair()
    assert pair.run("ingest_file", "song.mp3", b"\xff\xfbbinary",
                    document_id="bad").failed_tasks == 1
    assert pair.run("ingest_text", "perfectly fine text " * 30,
                    document_id="good").failed_tasks == 0
    pair.check()


def test_queue_chaos():
    """tests/test_ingest.py's chaos run on both queues, from one seed:
    the same tasks fail, after the same attempts, with the same errors."""

    def chaos(queue_cls, task_cls, task_type, fatal_error):
        rng = np.random.default_rng(0)
        q = queue_cls(max_retries=3, max_concurrency=8)
        n_tasks = 200
        fail_p = {i: float(rng.random() * 0.8) for i in range(n_tasks)}
        fatal = set(int(i) for i in rng.choice(n_tasks, 10, replace=False))
        seen = []

        async def handler(task):
            i = task.payload["i"]
            seen.append(i)
            if i in fatal:
                raise fatal_error("fatal")
            if rng.random() < fail_p[i]:
                raise RuntimeError("transient")

        async def producer(lo, hi):
            for i in range(lo, hi):
                await q.put(task_cls(task_type.DIRECT_CHUNK, {"i": i},
                                     priority=int(rng.integers(0, 256))))

        async def main():
            await asyncio.gather(*[producer(j * 50, (j + 1) * 50)
                                   for j in range(4)])
            await q.run(handler)

        asyncio.run(main())
        info = q.queue_info()
        assert info["succeeded"] + info["failed"] == n_tasks
        return (seen, [(t.payload["i"], t.attempts, t.error, t.task_id)
                       for t in q.failed],
                [(s["task_id"], s["attempts"]) for s in q.succeeded])

    assert chaos(WorkQueue, Task, TaskType, NonRetryableError) == chaos(
        JWorkQueue, JTask, JTaskType, JNonRetryableError)


# ------------------------------------------ tests/test_object_store.py, filetype

@pytest.mark.parametrize("concurrency", [1, 4])
def test_page_handoff_through_store(tmp_path, concurrency):
    pair = Pair(tmp_path, concurrency=concurrency)
    text = ("page content about retrieval systems. " * 15).encode()
    res = pair.run("ingest_file", "report.pdf", text, document_id="doc1",
                   mime="application/pdf")
    assert res.failed_tasks == 0 and res.chunks >= 2
    assert pair.tstore.list_objects("doc1") == pair.jstore.list_objects("doc1")
    for key in pair.jstore.list_objects("doc1"):
        assert pair.tstore.get_object(key) == pair.jstore.get_object(key)
    pair.check()


def test_reingest_replaces_objects(tmp_path):
    pair = Pair(tmp_path)
    pair.run("ingest_file", "r.pdf", b"first version " * 40,
             document_id="doc1", mime="application/pdf")
    pair.run("ingest_file", "r.pdf", b"second " * 10, document_id="doc1",
             mime="application/pdf")
    keys = pair.jstore.list_objects("doc1")
    assert pair.tstore.list_objects("doc1") == keys
    assert pair.tstore.get_object("doc1/pages/1.txt").startswith(b"second")
    for key in keys:
        assert pair.tstore.get_object(key) == pair.jstore.get_object(key)
    pair.check()


def test_missing_page_object_nonretryable(tmp_path):
    pair = Pair(tmp_path)
    payload = {"document_id": "doc1", "page_number": 1,
               "text_key": "doc1/pages/999.txt"}
    with pytest.raises(JNonRetryableError) as je:
        asyncio.run(pair.j._handle_unstructured_page(
            JTask(JTaskType.UNSTRUCTURED_PAGE, dict(payload))))
    with pytest.raises(NonRetryableError) as te:
        asyncio.run(pair.t._handle_unstructured_page(
            Task(TaskType.UNSTRUCTURED_PAGE, dict(payload))))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name,data,mime", [
    ("upload-42", b"name,age\nalice,30\nbob,25\n", None),
    ("blob", b"name,age\nalice,30\nbob,25\n", "application/octet-stream"),
    ("export", b"name\tage\nalice\t30\nbob\t25\n", None),
])
def test_sniffed_structured(name, data, mime):
    pair = Pair()
    res = pair.run("ingest_file", name, data, document_id="sniffed",
                   mime=mime)
    assert res.chunks == 1 and res.failed_tasks == 0
    rows = pair.tcol.payloads.rows_where(document_id="sniffed")
    assert pair.tcol.payloads.get(rows[0])["source"] == "structured"
    assert pair.tkg.stats()["column"] == 2
    pair.check()


# ------------------------------------------------------------------ documents

def built_pdf():
    return build_pdf([text_page(["Vivek wrote about retrieval systems.",
                                 "Page one of a built document."]),
                      text_page(["Dense and sparse retrieval, fused."]),
                      text_page(["The last page."])])


DOCUMENTS = {
    "sample.pdf": lambda: read("sample.pdf"),
    "sample.docx": lambda: read("sample.docx"),
    "sample.pptx": lambda: read("sample.pptx"),
    "built.pdf": built_pdf,
    "built.docx": lambda: build_docx([["Vivek's notes on retrieval."],
                                      ["A second page.", "With two lines."]]),
    "Resume.pdf": lambda: read("real", "Resume.pdf"),
    "ragas_papers.pdf": lambda: read("real", "ragas_papers.pdf"),
    "cube.PDF": lambda: read("real", "cube.PDF"),
    "Vivek Malipatel - Resume.docx":
        lambda: read("real", "Vivek Malipatel - Resume.docx"),
    "Intro To ML - Slide.pptx": lambda: read("real", "Intro To ML - Slide.pptx"),
}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_document(name):
    pair = Pair()
    res = pair.run("ingest_file", name, DOCUMENTS[name](), document_id=name)
    assert res.failed_tasks == 0 and res.chunks == res.pages >= 1
    pair.check("retrieval" if name == "built.pdf" else None)


def test_documents_concurrent(tmp_path):
    """Several documents at the default concurrency, with the object
    store: keyed writes, payloads and tables agree."""
    pair = Pair(tmp_path, concurrency=IngestConfig().max_concurrency,
                kg_extractor=graph_extractor)
    for name in ("sample.pdf", "built.pdf", "sample.docx", "sample.pptx"):
        pair.run("ingest_file", name, DOCUMENTS[name](), document_id=name)
    pair.run("ingest_text", "Vivek built a retrieval engine. " * 30,
             document_id="notes")
    pair.check()
