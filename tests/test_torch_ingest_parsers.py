"""The host modules the port copies for ingest, against their sources, on
the same bytes: `ingest/{chunker,queue,filetype,office,pdf,pdf_crypt,
ccitt,jbig2,video}.py`, `store/objects.py` and `tools/{registry,web}.py`.

Each copy must be its source verbatim below the header that names it
(`native/jbig2.c` too), and each function must give the same result on
the same input, exactly: equal bytes, strings and arrays (dtype and
all), or the same exception with the same message. The inputs are those
that tests/test_{pdf,office,jbig2,ccitt,video,filetype,object_store,
web_tools}.py build in code, and the fixtures.
"""

import ast
import asyncio
import importlib
import io
import os
import random
import re
import zipfile
import zlib

import numpy as np
import pytest

from fixtures.make_fixtures import build_docx, build_pdf, build_pptx, text_page
from test_ccitt import g4_encode
from test_jbig2 import _scanned_pdf, text_like
from test_pdf import build_encrypted_pdf, build_image_pdf, build_modern_pdf
from test_video import build_avi, jpeg_blob

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(_REPO, "tests", "fixtures")
COPIED = ["ingest.chunker", "ingest.queue", "ingest.filetype",
          "ingest.office", "ingest.pdf_crypt", "ingest.ccitt",
          "ingest.jbig2", "ingest.pdf", "ingest.video", "ingest.pipeline",
          "tools.registry", "tools.web", "store.objects"]


def pair(name):
    """(the JAX package's module, the port's copy)."""
    return (importlib.import_module(f"rag_application_tpu.{name}"),
            importlib.import_module(f"rag_application_tpu_torch.{name}"))


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return ("raise", type(e).__name__, str(e))


def assert_same(a, b):
    """Equal, with numpy arrays equal in dtype, shape and every element."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            assert_same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert type(a).__name__ == type(b).__name__ and a == b


def same(module, fn, *args, **kwargs):
    """``module.fn`` in both packages on the same arguments: the same
    result or the same exception. Returns the port's outcome."""
    j, t = pair(module)
    want = outcome(getattr(j, fn), *args, **kwargs)
    got = outcome(getattr(t, fn), *args, **kwargs)
    assert_same(got, want)
    return got


def read(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


# --------------------------------------------------------------- the copies

def body(source):
    """A module's source below its docstring."""
    doc = ast.parse(source).body[0]
    return "\n".join(source.split("\n")[doc.end_lineno:])


@pytest.mark.parametrize("name", COPIED)
def test_copy_is_verbatim(name):
    path = name.replace(".", "/") + ".py"
    with open(os.path.join(_REPO, "rag_application_tpu", path)) as f:
        src = f.read()
    with open(os.path.join(_REPO, "rag_application_tpu_torch", path)) as f:
        copy = f.read()
    assert f"Copy of `rag_application_tpu/{path}`" in copy
    assert body(copy) == body(src)
    assert not re.search(r"^\s*(from|import) (jax|flax|rag_application_tpu)\b",
                         copy, re.M)


def test_jbig2_c_is_verbatim():
    with open(os.path.join(_REPO, "rag_application_tpu/native/jbig2.c")) as f:
        src = f.read()
    with open(os.path.join(_REPO,
                           "rag_application_tpu_torch/native/jbig2.c")) as f:
        copy = f.read()
    assert copy == "/* Copy of rag_application_tpu/native/jbig2.c. */\n\n" + src


# ------------------------------------------------------------------ chunker

def long_text():
    return "\n\n".join(same("ingest.pdf", "extract_pages",
                            read("real", "ragas_papers.pdf"))[1])


CHUNKS = {
    "words-50": ("chunk_words", lambda: "word " * 100, (50,)),
    "overlong": ("chunk_words", lambda: "tiny " + "x" * 100 + " small", (50,)),
    "paper-8000": ("chunk_words", long_text, (8000,)),
    "paper-200": ("chunk_words", long_text, (200,)),
    "paragraphs": ("chunk_text", lambda: "\n\n".join(
        f"paragraph number {i} " + "filler " * 30 for i in range(10)),
        (400, 50)),
    "headings": ("chunk_text", lambda: (
        "intro text\n\n# Section One\n\nbody\n\n# Section Two\n\nmore"),
        (10_000, 0)),
    "paper-text": ("chunk_text", long_text, (1000, 100)),
    "empty": ("chunk_words", lambda: "", (8000,)),
}


@pytest.mark.parametrize("case", list(CHUNKS))
def test_chunker(case):
    fn, text, args = CHUNKS[case]
    kind, chunks = same("ingest.chunker", fn, text(), *args)
    assert kind == "ok"


# -------------------------------------------------------------------- queue

def queue_scenario(mod, scenario):
    """One of tests/test_ingest.py's queue runs on ``mod``'s WorkQueue:
    the order tasks ran in, the failed ledger and the audit records
    (without their clock readings)."""
    Task, TaskType = mod.Task, mod.TaskType
    order = []

    async def main():
        if scenario == "priority":
            q = mod.WorkQueue(max_retries=3, max_concurrency=1)
            for n, tt, pr in ((3, TaskType.UNSTRUCTURED_PAGE, 10),
                              (1, TaskType.FILE, 255),
                              (2, TaskType.DIRECT_CHUNK, 100)):
                await q.put(Task(tt, {"n": n}, priority=pr))

            async def handler(task):
                order.append(task.payload["n"])
        elif scenario == "retry":
            q = mod.WorkQueue(max_retries=3, max_concurrency=2)
            attempts = {"flaky": 0}

            async def handler(task):
                order.append(task.payload["kind"])
                if task.payload["kind"] == "fatal":
                    raise mod.NonRetryableError("no such key")
                attempts["flaky"] += 1
                if attempts["flaky"] < 3:
                    raise RuntimeError("transient")

            await q.put(Task(TaskType.DIRECT_CHUNK, {"kind": "flaky"}))
            await q.put(Task(TaskType.DIRECT_CHUNK, {"kind": "fatal"}))
        elif scenario == "exhaust":
            q = mod.WorkQueue(max_retries=2, max_concurrency=1)

            async def handler(task):
                order.append(task.attempts)
                raise RuntimeError("always")

            await q.put(Task(TaskType.DIRECT_CHUNK, {}))
        else:  # "bounded": drop-head eviction
            q = mod.WorkQueue(max_concurrency=1, max_length=3)
            for n, pr in (("hi", 255), ("mid", 100), ("low", 1),
                          ("mid2", 90)):
                await q.put(Task(TaskType.DIRECT_CHUNK, {"n": n},
                                 priority=pr))

            async def handler(task):
                order.append(task.payload["n"])
        await q.run(handler)
        return q

    q = asyncio.run(main())
    return (order, [(t.task_type.value, t.payload, t.attempts, t.error,
                     t.state.value, t.task_id) for t in q.failed],
            [{k: v for k, v in s.items() if k != "processing_time_seconds"}
             for s in q.succeeded], q.queue_info())


@pytest.mark.parametrize("scenario", ["priority", "retry", "exhaust",
                                      "bounded"])
def test_queue(scenario):
    j, t = pair("ingest.queue")
    assert queue_scenario(t, scenario) == queue_scenario(j, scenario)


def test_queue_priorities_and_loops():
    """`task_priority` over every task type, and one queue run by two
    event loops in turn (its condition rebinds to each)."""
    j, t = pair("ingest.queue")
    for tt in t.TaskType:
        for i in range(0, 300, 7):
            assert t.task_priority(tt, i) == j.task_priority(
                j.TaskType(tt.value), i)
    assert [m.value for m in t.TaskType] == [m.value for m in j.TaskType]
    assert [m.value for m in t.TaskState] == [m.value for m in j.TaskState]

    def two_loops(mod):
        q, seen = mod.WorkQueue(max_concurrency=2), []

        async def handler(task):
            seen.append(task.payload["i"])

        for lo in (0, 5):
            async def one(lo=lo):
                for i in range(lo, lo + 5):
                    await q.put(mod.Task(mod.TaskType.DIRECT_CHUNK, {"i": i},
                                         priority=i % 3))
                await q.run(handler)
            asyncio.run(one())
        return seen, q.queue_info()

    assert two_loops(t) == two_loops(j)


# ----------------------------------------------------------------- filetype

def zip_with(*names):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for n in names:
            z.writestr(n, b"x")
    return buf.getvalue()


SNIFF = {
    "pdf": b"%PDF-1.7 rest", "png": b"\x89PNG\r\n\x1a\nxxxx",
    "jpeg": b"\xff\xd8\xff\xe0junk", "gif": b"GIF89a....",
    "parquet": b"PAR1....", "zeros": b"\x00" * 100,
    "webp": b"RIFF\x00\x00\x00\x00WEBPVP8 ",
    "wav": b"RIFF\x00\x00\x00\x00WAVEfmt ",
    "mp4": b"\x00\x00\x00\x18ftypmp42more",
    "xlsx": zip_with("[Content_Types].xml", "xl/workbook.xml"),
    "docx-zip": zip_with("[Content_Types].xml", "word/document.xml"),
    "zip": zip_with("random.bin"), "json": b'{"a": 1}',
    "html": b"<html><body>x</body></html>", "csv": b"a,b,c\n1,2,3\n4,5,6\n",
    "tsv": b"name\tage\nalice\t30\nbob\t25\n",
    "markdown": b"# Title\n\nbody text",
    "text": b"plain words here\nand more\n",
    "bm-text": b"BM25 scoring notes for the sparse index\n",
    "id3-text": b"ID3 tags explained\nand more text\n",
    "bmp": b"BM" + bytes(range(64)), "mp3": b"ID3\x03\x00" + bytes(64),
    "utf16": "words".encode("utf-16"), "empty": b"",
    "avi": build_avi([jpeg_blob(0)]),
}
FILES = {
    "sample.pdf": ("sample.pdf",), "sample.docx": ("sample.docx",),
    "sample.pptx": ("sample.pptx",), "Pokemon.csv": ("real", "Pokemon.csv"),
    "Resume.pdf": ("real", "Resume.pdf"), "cube.PDF": ("real", "cube.PDF"),
    "Intro To ML - Slide.pptx": ("real", "Intro To ML - Slide.pptx"),
}


@pytest.mark.parametrize("case", list(SNIFF) + list(FILES))
def test_detect_mime(case):
    data = read(*FILES[case]) if case in FILES else SNIFF[case]
    for name in ("", case, "upload.bin", "notes.txt"):
        kind, mime = same("ingest.filetype", "detect_mime", data, name)
        assert kind == "ok"
        same("ingest.pipeline", "classify_file", name or "blob", mime)


# ------------------------------------------------------------------- office

def docx_with(xml: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("[Content_Types].xml", "<Types/>")
        z.writestr("word/document.xml", xml)
    return buf.getvalue()


OFFICE = {
    "sample.docx": lambda: read("sample.docx"),
    "sample.pptx": lambda: read("sample.pptx"),
    "real.docx": lambda: read("real", "Vivek Malipatel - Resume.docx"),
    "real.pptx": lambda: read("real", "Intro To ML - Slide.pptx"),
    "built.docx": lambda: build_docx([["one", "two"], ["three"], []]),
    "built.pptx": lambda: build_pptx([["a"], ["b", "c"]] + [["x"]] * 10),
    "bad-zip": lambda: b"PK\x03\x04garbage",
    "empty-zip": lambda: zip_with("random.bin"),
    "bad-xml": lambda: docx_with("<w:document><unclosed>"),
    "not-zip": lambda: b"plain text",
}


@pytest.mark.parametrize("case", list(OFFICE))
def test_office(case):
    data = OFFICE[case]()
    for fn in ("is_ooxml", "ooxml_kind", "extract_pages"):
        same("ingest.office", fn, data)


# ---------------------------------------------------------------------- pdf

def gray_image_pdf():
    samples = bytes((x * 7 + y * 3) & 0xFF for y in range(8) for x in range(6))
    comp = zlib.compress(samples)
    return build_image_pdf(
        b"<< /Subtype /Image /Width 6 /Height 8 /BitsPerComponent 8 "
        b"/ColorSpace /DeviceGray /Filter /FlateDecode /Length %d >>"
        % len(comp), comp)


def dct_image_pdf():
    jpeg = b"\xff\xd8\xff\xe0" + b"JFIFDATA" * 20 + b"\xff\xd9"
    return build_image_pdf(
        b"<< /Subtype /Image /Width 100 /Height 100 /BitsPerComponent 8 "
        b"/ColorSpace /DeviceRGB /Filter /DCTDecode /Length %d >>"
        % len(jpeg), jpeg)


def indexed_image_pdf():
    comp = zlib.compress(bytes([0, 1, 2, 1, 2, 0, 1, 0]))
    palette = bytes([255, 0, 0, 0, 255, 0, 0, 0, 255])
    return build_image_pdf(
        b"<< /Subtype /Image /Width 4 /Height 2 /BitsPerComponent 8 "
        b"/ColorSpace [/Indexed /DeviceRGB 2 <%s>] "
        b"/Filter /FlateDecode /Length %d >>"
        % (palette.hex().encode(), len(comp)), comp)


def ccitt_image_pdf():
    rng = np.random.default_rng(3)
    bitmap = (rng.random((24, 40)) < 0.2).astype(np.uint8)
    g4 = g4_encode(bitmap)
    return build_image_pdf(
        b"<< /Subtype /Image /Width 40 /Height 24 /BitsPerComponent 1 "
        b"/ColorSpace /DeviceGray /Filter /CCITTFaxDecode "
        b"/DecodeParms << /K -1 /Columns 40 /Rows 24 >> /Length %d >>"
        % len(g4), g4)


def jbig2_image_pdf():
    _, t = pair("ingest.jbig2")
    return _scanned_pdf(t.encode_embedded(text_like()), 96, 64)


def mutations(n):
    """tests/test_pdf.py's mutated PDFs: bytes flipped, truncated, or
    garbage spliced in, from one seed."""
    base = build_pdf([text_page(["stable text here"]),
                      text_page(["second page"])])
    rng = random.Random(0)
    out = []
    for trial in range(n):
        data = bytearray(base)
        if trial % 3 == 0:
            for _ in range(rng.randint(1, 8)):
                data[rng.randrange(len(data))] = rng.randrange(256)
        elif trial % 3 == 1:
            data = data[: rng.randrange(6, len(data))]
        else:
            pos = rng.randrange(len(data))
            data[pos:pos] = bytes(rng.randrange(256) for _ in range(16))
        out.append(bytes(data))
    return out


PDFS = {
    "sample.pdf": lambda: read("sample.pdf"),
    "Resume.pdf": lambda: read("real", "Resume.pdf"),
    "ragas_papers.pdf": lambda: read("real", "ragas_papers.pdf"),
    "cube.PDF": lambda: read("real", "cube.PDF"),
    "built": lambda: build_pdf([text_page(["alpha (beta)", "gamma"]),
                                text_page(["delta"])]),
    "built-uncompressed": lambda: build_pdf([text_page(["plain"])],
                                            compress=False),
    "modern-predictor": lambda: build_modern_pdf(True),
    "modern": lambda: build_modern_pdf(False),
    "rc4_40": lambda: build_encrypted_pdf(["classified alpha", "bravo 42"],
                                          "rc4_40"),
    "rc4_128": lambda: build_encrypted_pdf(["classified"], "rc4_128"),
    "aes128": lambda: build_encrypted_pdf(["classified"], "aes128"),
    "aes256": lambda: build_encrypted_pdf(["classified"], "aes256"),
    "aes256-password": lambda: build_encrypted_pdf(
        ["classified"], "aes256", user_pwd=b"hunter2", owner_pwd=b"hunter2"),
    "rc4-password": lambda: build_encrypted_pdf(
        ["classified"], "rc4_128", user_pwd=b"hunter2", owner_pwd=b"hunter2"),
    "gray-image": gray_image_pdf,
    "dct-image": dct_image_pdf,
    "indexed-image": indexed_image_pdf,
    "ccitt-image": ccitt_image_pdf,
    "jbig2-image": jbig2_image_pdf,
    "not-a-pdf": lambda: b"hello world",
    "garbage-encrypt": lambda: build_pdf([text_page(["x"])]).replace(
        b"/Root 1 0 R", b"/Root 1 0 R /Encrypt << /Filter /Bogus >>"),
}


@pytest.mark.parametrize("case", list(PDFS))
def test_pdf(case):
    data = PDFS[case]()
    for fn in ("is_pdf", "page_count", "extract_pages", "extract_page_images"):
        same("ingest.pdf", fn, data)


def test_pdf_mutations():
    for data in mutations(60):
        same("ingest.pdf", "extract_pages", data)
        same("ingest.pdf", "extract_page_images", data)


def test_pdf_crypt_primitives():
    rng = np.random.default_rng(0)

    def b(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    for n in (0, 1, 15, 16, 17, 100):
        key, iv, data = b(16), b(16), b(n)
        same("ingest.pdf_crypt", "rc4", key[:5 + n % 11], data)
        enc = same("ingest.pdf_crypt", "aes_cbc_encrypt", key, iv, data)
        if enc[0] == "ok":
            same("ingest.pdf_crypt", "aes_cbc_decrypt", key, iv, enc[1])
        same("ingest.pdf_crypt", "aes_cbc_encrypt", b(32), iv, data)
        same("ingest.pdf_crypt", "aes_cbc_decrypt", key, iv, data)
        same("ingest.pdf_crypt", "aes_cbc_encrypt", key, iv, data + b"x" * (
            -n % 16))
    same("ingest.pdf_crypt", "hash_r6", b"pw", b(8), b(48))
    same("ingest.pdf_crypt", "hash_r6", b"", b(8))
    for rev in (2, 3, 4):
        for meta in (True, False):
            same("ingest.pdf_crypt", "file_key_r2_r4", b"", b(32), -4, b(16),
                 rev, 16 if rev > 2 else 5, meta)
        same("ingest.pdf_crypt", "user_check_bytes", b(16), b(16), rev)


# -------------------------------------------------------------------- ccitt

CCITT = [((16, 64), 0.5, 0), ((23, 100), 0.1, 1), ((8, 1728), 0.02, 2),
         ((40, 33), 0.9, 3)]


@pytest.mark.parametrize("shape,density,seed", CCITT)
def test_ccitt_g4(shape, density, seed):
    rng = np.random.default_rng(seed)
    bitmap = (rng.random(shape) < density).astype(np.uint8)
    data = g4_encode(bitmap)
    h, w = shape
    same("ingest.ccitt", "decode_ccitt", data, w, rows=h, k=-1)
    same("ingest.ccitt", "decode_ccitt", data[: len(data) // 2], w, k=-1)
    same("ingest.ccitt", "decode_ccitt_params", data,
         {"K": -1, "Columns": w}, w, h)
    same("ingest.ccitt", "decode_ccitt_params", data,
         {"K": -1, "Columns": w, "BlackIs1": True}, w, h)


def test_ccitt_g3_and_garbage():
    bits = "1011" + "11" + "00111"
    data = int(bits + "0" * (8 - len(bits) % 8), 2).to_bytes(
        (len(bits) + 7) // 8, "big")
    same("ingest.ccitt", "decode_ccitt", data, 16, rows=1, k=0)
    same("ingest.ccitt", "decode_ccitt", b"\x00\x00\x00\x00", 64, rows=4,
         k=-1)
    rng = random.Random(1)
    for _ in range(20):
        soup = bytes(rng.randrange(256) for _ in range(24))
        same("ingest.ccitt", "decode_ccitt", soup, 48, rows=6, k=-1)
        same("ingest.ccitt", "decode_ccitt", soup, 48, rows=6, k=0)


# -------------------------------------------------------------------- jbig2

def glyphs(rng, shapes):
    return [(rng.random(s) < 0.5).astype(np.uint8) for s in shapes]


JBIG2 = {
    "generic-t0": lambda j, rng: j.encode_generic(text_like(), template=0),
    "generic-t1": lambda j, rng: j.encode_generic(text_like(), template=1),
    "generic-t2": lambda j, rng: j.encode_generic(text_like(), template=2),
    "generic-t3-tpgdon": lambda j, rng: j.encode_generic(
        text_like(), template=3, tpgdon=True),
    "noise": lambda j, rng: j.encode_generic(
        (rng.random((40, 56)) < 0.5).astype(np.uint8)),
    "embedded-xnor": lambda j, rng: j.encode_embedded(text_like(seed=5),
                                                      op=3),
    "embedded-mmr": lambda j, rng: j.encode_embedded(
        text_like(seed=2), mmr_data=g4_encode(text_like(seed=2))),
    "symbol-text": lambda j, rng: j.encode_symbol_text(
        glyphs(rng, [(12, 8), (12, 10), (9, 7), (9, 9)]),
        [(0, 3, 2), (1, 15, 2), (2, 30, 4), (3, 40, 4), (0, 3, 20)], 56, 36),
    "symbol-huffman": lambda j, rng: j.encode_symbol_text_huffman(
        glyphs(rng, [(6, 5), (6, 4), (8, 7)]),
        [(0, 2, 1), (1, 10, 1), (2, 3, 12), (0, 14, 12)], page_w=40,
        page_h=24),
    "symbol-huffman-custom": lambda j, rng: j.encode_symbol_text_huffman(
        glyphs(rng, [(5, 6), (5, 3)]), [(0, 1, 2), (1, 9, 2), (0, 30, 2)],
        page_w=40, page_h=16, custom_ds=True),
    "halftone": lambda j, rng: j.encode_halftone(
        rng.integers(0, 6, size=(7, 9)),
        [(rng.random((4, 4)) < lvl / 5.0).astype(np.uint8)
         for lvl in range(6)], page_w=36, page_h=28),
    "refined": lambda j, rng: j.encode_refined_page(
        text_like(seed=1), text_like(seed=1) ^ (
            rng.random((64, 96)) < 0.02).astype(np.uint8)),
}


@pytest.mark.parametrize("case", list(JBIG2))
def test_jbig2(case):
    """The same encoder bytes from both copies, decoded alike by both
    (the port's decoder runs its own build of `native/jbig2.c`)."""
    j, t = pair("ingest.jbig2")
    enc_j = JBIG2[case](j, np.random.default_rng(7))
    enc_t = JBIG2[case](t, np.random.default_rng(7))
    assert enc_t == enc_j
    if case.startswith(("generic", "noise")):
        h, w = (40, 56) if case == "noise" else (64, 96)
        kw = {"template": int(case[9]) if case.startswith("generic") else 0,
              "tpgdon": case.endswith("tpgdon")}
        kind, got = same("ingest.jbig2", "decode_generic", enc_j, w, h, **kw)
    else:
        kind, got = same("ingest.jbig2", "decode_embedded", enc_j)
    assert kind == "ok" and got.size
    same("ingest.jbig2", "decode_embedded", enc_j[: len(enc_j) // 2])


def test_jbig2_errors_and_params():
    _, t = pair("ingest.jbig2")
    same("ingest.jbig2", "decode_generic", b"\x00" * 16, 100_000, 100_000)
    same("ingest.jbig2", "decode_generic", b"", 0, 4)
    same("ingest.jbig2", "decode_embedded", b"\x00\x01\x02 garbage")
    page = t.encode_embedded(text_like())
    same("ingest.jbig2", "decode_jbig2_params", page, b"", 96, 64)
    same("ingest.jbig2", "decode_jbig2_params", page, b"", 90, 64)


# -------------------------------------------------------------------- video

VIDEOS = {
    "six": lambda: build_avi([jpeg_blob(i) for i in range(6)]),
    "twenty": lambda: build_avi([jpeg_blob(i) for i in range(20)]),
    "one": lambda: build_avi([jpeg_blob(0)]),
    "dib": lambda: build_avi([b"\x00" * 32], codec=b"DIB "),
    "not-avi": lambda: b"RIFF\x00\x00\x00\x00WAVEfmt ",
    "truncated": lambda: build_avi([jpeg_blob(i) for i in range(4)])[:70],
}


@pytest.mark.parametrize("case", list(VIDEOS))
def test_video(case):
    data = VIDEOS[case]()
    info = same("ingest.video", "probe_avi", data)
    for n in (1, 3, 8):
        same("ingest.video", "extract_frames", data, max_frames=n)
        if info[0] == "ok":
            same("ingest.video", "frame_timestamps", info[1], n)


# ------------------------------------------------------------------ objects

def store_run(mod, root):
    """The same operations on ``mod``'s ObjectStore under ``root``: each
    operation's outcome, then every file under the root and its bytes."""
    st = mod.ObjectStore(root)
    ops = [("put_object", "doc1/original/a.pdf", b"pdf bytes"),
           ("put_object", "doc1/pages/1.txt", b"page one"),
           ("put_object", "doc1/pages/2.txt", b"page two"),
           ("put_object", "doc2/x", b"other"),
           ("get_object", "doc1/pages/1.txt"), ("get_object", "missing"),
           ("object_exists", "doc2/x"), ("object_exists", "nope"),
           ("list_objects", "doc1"), ("list_objects", ""),
           ("put_object", "../escape", b"x"), ("get_object", "/etc/passwd"),
           ("put_object", "k", b"default"),
           ("delete_object", "doc2/x"), ("delete_object", "doc2/x"),
           ("delete_prefix", "doc1"), ("list_objects", "")]
    out = [outcome(getattr(st, op), *args) for op, *args in ops]
    out.append(outcome(st.put_object, "k", b"other", bucket="b2"))
    out.append(outcome(st.get_object, "k", bucket="b2"))
    out.append(outcome(st.list_objects, "", bucket="b2"))
    out.append(outcome(st.build_document_base_path, "u1", "d1"))
    out.append(outcome(asyncio.run, st.aput_object("a/1", b"async")))
    out.append(outcome(asyncio.run, st.aget_object("a/1")))
    out.append(outcome(asyncio.run, st.adelete_prefix("a")))
    files = sorted((os.path.relpath(os.path.join(d, f), root),
                    open(os.path.join(d, f), "rb").read())
                   for d, _, fs in os.walk(root) for f in fs)
    return out, files


def test_object_store(tmp_path):
    j, t = pair("store.objects")
    want = store_run(j, tmp_path / "jax")
    got = store_run(t, tmp_path / "port")
    assert_same(got, want)


# --------------------------------------------------------- tools: web, registry

HTML = {
    "page": """<html><head><style>body{}</style>
    <script>alert(1)</script></head>
    <body><h1>Title</h1><p>First &amp; second.</p>
    <div>Third&nbsp;part</div></body></html>""",
    "fetched": ("<html><head><script>x()</script></head><body>"
                "<h1>Retrieval</h1><p>" + "engine facts. " * 40
                + "</p></body></html>"),
    "entities": "<p>&lt;tag&gt; &quot;q&quot; &#39;s&#39; &#x41; &euro;</p>",
    "nested": "<ul><li>a<li>b</ul><table><tr><td>1<td>2</table><br/>end",
    "plain": "no markup at all\n\n\nlines",
}


@pytest.mark.parametrize("case", list(HTML))
def test_html_to_text(case):
    same("tools.web", "html_to_text", HTML[case])


def test_web_tools_and_registry():
    j, t = pair("tools.web")
    jr, tr = pair("tools.registry")

    async def backend(query, k):
        return [{"title": f"result {i} for {query}", "url": f"http://x/{i}",
                 "snippet": "snip"} for i in range(10)][:k]

    async def fetch(url):
        return HTML["page"]

    def run(web, reg):
        tools = [web.web_search_tool(backend), web.web_scrape_tool(fetch)]
        registry = reg.ToolRegistry(tools)
        calls = [{"name": "web_search", "arguments": {"query": "tpus"}},
                 {"name": "web_search",
                  "arguments": '{"query": "gpus", "k": 2}'},
                 {"name": "web_scrape",
                  "arguments": {"url": "http://e.com", "max_chars": 12}},
                 {"name": "missing", "arguments": {}},
                 {"name": "web_search", "arguments": "{not json"}]
        return (registry.names(), registry.specs(), len(registry),
                [asyncio.run(registry.execute_call(c)) for c in calls])

    assert_same(run(t, tr), run(j, jr))
