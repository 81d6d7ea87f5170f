"""Ingest pipeline: classify -> fan out -> process -> index.

Copy of `rag_application_tpu/ingest/pipeline.py`, on the port's
`Embedder` (whose `encode` returns numpy, as the reference's does),
`Collection` and `KGStore`: every chunk task's `store_document_vectors`
and every KG row's insert runs the insert prep kernel
(`ops/quant.py::prepare_vectors_into`) on the collection's device. The
image, audio and MJPEG-video branches import the port's copies of
`models.image`, `models.jpeg` and `models.audio` (and `ingest.flac`):
with a multimodal `Embedder` (`supports_images`/`supports_audio`), such
files become chunks embedded by the tower's patch branches; with a text
tower they fail into the ledger with the reference's messages.

Parity: the v2 IndexerAPI flow (SURVEY §3.3) —
  FileProcessor classifies into unstructured / structured / direct
  (IndexerAPI/src/core/processors/file_processor.py:38-75,118-130), then
  fans out page/sheet/chunk tasks into the queue (:150-252); processors
  extract text, optionally run KG extraction + embeddings, and upsert
  page-level into the index (_unstructured_processor.py,
  _structured_processor.py, _direct_processor.py); Orchestrator routes
  TaskType -> processor (services/orchestrator.py:11-35).

Here the pipeline feeds a Collection (chunk index) and optionally a
KGStore (graph index), with the Embedder batching encode calls. External
converters (unoserver PDF conversion, VLM page description, magika) are
pluggable hooks; text/markdown and CSV are handled natively. Everything
is restartable: tasks are idempotent (document reset before re-insert)
and the queue keeps the retry/failed/success ledger.
"""

from __future__ import annotations

import asyncio
import io
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..config import IngestConfig
from ..models.embedder import Embedder
from ..store.collection import Collection
from .chunker import chunk_words
from .filetype import detect_mime
from .queue import NonRetryableError, Task, TaskType, WorkQueue, task_priority

STRUCTURED_SUFFIXES = {".csv", ".tsv", ".xlsx", ".xls", ".parquet"}
DIRECT_SUFFIXES = {".txt", ".md", ".markdown", ".rst", ".json", ".html", ".htm"}
IMAGE_SUFFIXES = {".png", ".jpg", ".jpeg", ".gif", ".webp", ".bmp"}
MEDIA_SUFFIXES = {".mp3", ".wav", ".flac", ".mp4", ".mov", ".avi", ".mkv"}


def classify_file(filename: str, mime: Optional[str] = None) -> str:
    """unstructured / structured / direct / image / media (parity:
    MIME-class routing, app/services/file_processor/file_processor.py:
    75-109 + IndexerAPI file_processor.py:38-75). Audio/video processors
    are declared-but-stub surface in the reference too (SURVEY §2.1
    'Stub processors')."""
    name = filename.lower()
    for suf in STRUCTURED_SUFFIXES:
        if name.endswith(suf):
            return "structured"
    for suf in DIRECT_SUFFIXES:
        if name.endswith(suf):
            return "direct"
    for suf in IMAGE_SUFFIXES:
        if name.endswith(suf):
            return "image"
    for suf in MEDIA_SUFFIXES:
        if name.endswith(suf):
            return "media"
    if mime:
        if "spreadsheet" in mime or "csv" in mime or "parquet" in mime:
            return "structured"
        if mime.startswith("text/") or mime == "application/json":
            return "direct"
        if mime.startswith("image/"):
            return "image"
        if mime.startswith(("audio/", "video/")):
            return "media"
    return "unstructured"


@dataclass
class IngestResult:
    document_id: str
    chunks: int = 0
    pages: int = 0
    failed_tasks: int = 0


class IngestPipeline:
    def __init__(
        self,
        collection: Collection,
        embedder: Embedder,
        *,
        kg=None,
        kg_extractor: Optional[Callable[[str], Any]] = None,
        page_describer: Optional[Callable[[bytes], str]] = None,
        pdf_rasterizer: Optional[Callable[[bytes, int], bytes]] = None,
        audio_decoder: Optional[Callable[[bytes], Any]] = None,
        audio_transcriber: Optional[Callable[[bytes], str]] = None,
        contextualizer=None,  # LLMRouter: enables contextual augmentation
        object_store=None,  # store.objects.ObjectStore: page-payload handoff
        url_fetcher=None,  # async url -> str: enables /ingest/url
        config: Optional[IngestConfig] = None,
    ):
        self.collection = collection
        self.embedder = embedder
        self.kg = kg
        self.kg_extractor = kg_extractor  # text -> {entities, relationships}
        self.page_describer = page_describer  # image bytes -> description
        # (pdf bytes, page_no) -> image bytes; enables the VLM flow for
        # scanned PDFs (parity: pdf2image rasterize, utils.py:16-22)
        self.pdf_rasterizer = pdf_rasterizer
        # bytes -> (waveform float32, sample_rate); decodes compressed
        # audio (mp3/flac/...) — WAV is handled natively (models/audio.py)
        self.audio_decoder = audio_decoder
        self.audio_transcriber = audio_transcriber  # bytes -> transcript
        self.contextualizer = contextualizer
        self.object_store = object_store
        self.url_fetcher = url_fetcher
        self.cfg = config or IngestConfig()
        self.queue = WorkQueue(
            max_retries=self.cfg.max_retries,
            max_concurrency=self.cfg.max_concurrency,
        )

    # --------------------------------------------------- contextualization

    async def _contextualize(self, chunks: List[str]) -> List[str]:
        """Contextual chunk augmentation (parity: text_processor.py:214-309
        — one doc-summary LLM call, then per-chunk context generated from
        the summary plus the ±2 neighboring chunks, all in parallel). The
        returned strings are stored alongside the chunk and prepended for
        embedding (context_version-style payload field)."""
        if self.contextualizer is None or not chunks:
            return ["" for _ in chunks]
        doc_text = "\n\n".join(chunks)[:16000]
        summary = await self.contextualizer.generate_text(
            f"Summarize this document in 3-5 sentences:\n{doc_text}",
            system="You write terse document summaries.")

        async def ctx(i: int) -> str:
            lo, hi = max(0, i - 2), min(len(chunks), i + 3)
            neighbors = "\n---\n".join(chunks[lo:hi])
            return await self.contextualizer.generate_text(
                f"Document summary: {summary}\n"
                f"Surrounding chunks:\n{neighbors[:6000]}\n"
                f"Target chunk:\n{chunks[i][:4000]}\n"
                "Write 1-2 sentences situating the target chunk within the "
                "document (for retrieval).",
                system="You write chunk context for retrieval augmentation.")

        return list(await asyncio.gather(*(ctx(i) for i in range(len(chunks)))))

    # ------------------------------------------------------------- ingest API

    async def ingest_file(self, filename: str, data: bytes,
                          *, document_id: Optional[str] = None,
                          mime: Optional[str] = None) -> IngestResult:
        """Parity surface: POST /ingest/file (IndexerAPI ingest.py:12-30)."""
        document_id = document_id or filename
        task = Task(TaskType.FILE,
                    {"filename": filename, "data": data,
                     "document_id": document_id, "mime": mime},
                    priority=task_priority(TaskType.FILE))
        failed_before = len(self.queue.failed)
        await self.queue.put(task)
        await self.queue.run(self._handle)
        return self._result(document_id, failed_before)

    async def ingest_text(self, text: str, *, document_id: str) -> IngestResult:
        """Parity surface: POST /ingest/raw-text (ingest.py:44-54)."""
        return await self.ingest_file(document_id + ".txt", text.encode(),
                                      document_id=document_id)

    async def ingest_url(self, url: str,
                         *, document_id: Optional[str] = None) -> IngestResult:
        """Parity surface: POST /ingest/url (ingest.py:32-42). The
        reference declares the endpoint but its Orchestrator raises
        NotImplementedError for URL tasks (orchestrator.py:24-27); here
        the task is implemented when a `url_fetcher` hook is configured
        (fetch -> readable text -> the FILE pipeline), and without one it
        fails into the ledger like any non-retryable task."""
        document_id = document_id or url
        task = Task(TaskType.URL, {"url": url, "document_id": document_id},
                    priority=task_priority(TaskType.URL))
        failed_before = len(self.queue.failed)
        await self.queue.put(task)
        await self.queue.run(self._handle)
        return self._result(document_id, failed_before)

    def _result(self, document_id: str, failed_before: int = 0) -> IngestResult:
        rows = self.collection.payloads.rows_where(document_id=document_id)
        pages = {self.collection.payloads.get(r).get("page_number", 0)
                 for r in rows}
        return IngestResult(
            document_id=document_id,
            chunks=len(rows),
            pages=len(pages),
            # failures from THIS ingest only — the ledger is append-only
            # across the pipeline's lifetime
            failed_tasks=len(self.queue.failed) - failed_before,
        )

    # ---------------------------------------------------------------- tasks

    async def _handle(self, task: Task) -> None:
        from ..utils.observability import METRICS

        with METRICS.stage_timer("ingest", task_type=task.task_type.value):
            await self._dispatch(task)

    async def _dispatch(self, task: Task) -> None:
        if task.task_type == TaskType.FILE:
            await self._handle_file(task)
        elif task.task_type == TaskType.URL:
            await self._handle_url(task)
        elif task.task_type == TaskType.DIRECT_CHUNK:
            await self._handle_direct_chunk(task)
        elif task.task_type == TaskType.STRUCTURED_CHUNK:
            await self._handle_structured_chunk(task)
        elif task.task_type == TaskType.UNSTRUCTURED_PAGE:
            await self._handle_unstructured_page(task)
        elif task.task_type == TaskType.AUDIO_CHUNK:
            await self._handle_audio_chunk(task)
        else:
            raise NonRetryableError(f"unsupported task type {task.task_type}")

    async def _handle_url(self, task: Task) -> None:
        p = task.payload
        if self.url_fetcher is None:
            raise NonRetryableError(
                "URL ingest requires a url_fetcher hook")
        content = await self.url_fetcher(p["url"])
        if isinstance(content, str):
            lowered = content[:512].lower()
            if "<html" in lowered or "<!doctype" in lowered:
                from ..tools.web import html_to_text

                content = html_to_text(content)
            content = content.encode()
        await self._handle_file(Task(TaskType.FILE, {
            "filename": p["url"].rstrip("/").rsplit("/", 1)[-1] or "page.txt",
            "data": content, "document_id": p["document_id"], "mime": None,
        }))

    async def _handle_file(self, task: Task) -> None:
        p = task.payload
        document_id = p["document_id"]
        # content sniff when the caller gave no USEFUL mime — HTTP clients
        # routinely send application/octet-stream for anything unknown
        # (parity: python-magic on the first 2KB regardless of the
        # declared type, file_processor.py:60-64; magika in v2)
        mime = p.get("mime")
        if not mime or mime == "application/octet-stream":
            mime = detect_mime(p["data"], p["filename"])
        kind = classify_file(p["filename"], mime)
        # idempotent re-ingest: reset previous state first
        self.collection.delete_document(document_id)
        if self.kg is not None:
            self.kg.reset_document(document_id)
        if self.object_store is not None:
            # keep the original upload (parity: S3 original + delete
            # cascade, IndexerAPI file_processor.py:132-148)
            await self.object_store.adelete_prefix(document_id)
            base = p["filename"].rsplit("/", 1)[-1]
            await self.object_store.aput_object(
                f"{document_id}/original/{base}", p["data"])

        if kind == "image":
            # image page: VLM description becomes the text (parity:
            # _unstructured_processor VLM alt-text path); without a VLM,
            # a natively-decodable raster (PNG/JPEG) still embeds
            # through the multimodal tower (parity: ImageBind vision,
            # imagebind_handler.py:23-32)
            if (self.page_describer is None
                    and not getattr(self.embedder, "supports_images",
                                    False)):
                raise NonRetryableError(
                    "image ingest requires a page_describer (VLM hook) "
                    "or an image-capable multimodal embedder")
            await self.queue.put(Task(
                TaskType.UNSTRUCTURED_PAGE,
                {"document_id": document_id, "page_number": 1,
                 "text": "", "image": p["data"]},
                priority=task_priority(TaskType.UNSTRUCTURED_PAGE, 0),
            ))
            return
        if kind == "media":
            # audio embeds through the multimodal tower's spectrogram
            # branch (parity: ImageBind audio, imagebind_handler.py:23-32)
            is_audio = (mime or "").startswith("audio/") or any(
                p["filename"].lower().endswith(s)
                for s in (".wav", ".mp3", ".flac", ".ogg", ".m4a"))
            if is_audio and getattr(self.embedder, "supports_audio", False):
                await self.queue.put(Task(
                    TaskType.AUDIO_CHUNK,
                    {"document_id": document_id, "data": p["data"],
                     "filename": p["filename"]},
                    priority=task_priority(TaskType.AUDIO_CHUNK, 0),
                ))
                return
            # video: MJPEG-AVI frames extract natively (ingest/video.py)
            # and ride the scanned-page path, one frame per page — VLM
            # description when a describer is configured, else a native
            # JPEG decode + multimodal-tower embedding (models/jpeg.py);
            # other codecs keep the reference's stub behavior
            # (file_processors video branch returns None) by failing
            # into the ledger instead of silently dropping
            is_video = (mime or "").startswith("video/") or any(
                p["filename"].lower().endswith(s)
                for s in (".avi", ".mp4", ".mkv", ".mov"))
            if is_video and (self.page_describer is not None or getattr(
                    self.embedder, "supports_images", False)):
                from .video import VideoError, extract_frames
                try:
                    frames = extract_frames(p["data"])
                except VideoError as e:
                    raise NonRetryableError(
                        f"video {p['filename']}: {e}") from e
                for i, jpeg in enumerate(frames):
                    await self.queue.put(Task(
                        TaskType.UNSTRUCTURED_PAGE,
                        {"document_id": document_id, "page_number": i + 1,
                         "text": "", "image": jpeg},
                        priority=task_priority(TaskType.UNSTRUCTURED_PAGE, i),
                    ))
                return
            raise NonRetryableError(
                f"no processor for media file {p['filename']}"
                + (" (audio needs a multimodal encoder)" if is_audio else "")
                + (" (video needs a page_describer VLM hook or an "
                   "image-capable multimodal embedder)"
                   if is_video else ""))
        if kind == "direct":
            try:
                text = p["data"].decode("utf-8")
            except UnicodeDecodeError as e:
                raise NonRetryableError(f"not utf-8 text: {e}") from e
            chunks = chunk_words(text, self.cfg.chunk_chars)
            contexts = await self._contextualize(chunks)
            for i, (chunk, ctx) in enumerate(zip(chunks, contexts)):
                await self.queue.put(Task(
                    TaskType.DIRECT_CHUNK,
                    {"document_id": document_id, "chunk_index": i,
                     "text": chunk, "context": ctx},
                    priority=task_priority(TaskType.DIRECT_CHUNK, i),
                ))
        elif kind == "structured":
            sheets = self._read_structured(p["filename"], p["data"], mime)
            for i, (sheet_name, df) in enumerate(sheets):
                await self.queue.put(Task(
                    TaskType.STRUCTURED_CHUNK,
                    {"document_id": document_id, "sheet_name": sheet_name,
                     "sheet_index": i, "records": df},
                    priority=task_priority(TaskType.STRUCTURED_CHUNK, i),
                ))
        else:
            pages = self._split_unstructured(p["filename"], p["data"])
            for i, page in enumerate(pages):
                payload: Dict[str, Any] = {
                    "document_id": document_id, "page_number": i + 1,
                    "text": page.get("text", ""),
                    "image": page.get("image"),
                }
                if self.object_store is not None:
                    # per-page payload handoff through the object store
                    # (parity: page PDFs uploaded to S3 and re-fetched by
                    # the page task, file_processor.py:150-184) — the task
                    # carries keys, not bytes, so the queue stays light and
                    # a restarted consumer can re-read its input.
                    text_key = f"{document_id}/pages/{i + 1}.txt"
                    await self.object_store.aput_object(
                        text_key, payload["text"].encode())
                    payload = {"document_id": document_id,
                               "page_number": i + 1, "text_key": text_key}
                    if page.get("image") is not None:
                        img_key = f"{document_id}/pages/{i + 1}.img"
                        await self.object_store.aput_object(
                            img_key, page["image"])
                        payload["image_key"] = img_key
                await self.queue.put(Task(
                    TaskType.UNSTRUCTURED_PAGE, payload,
                    priority=task_priority(TaskType.UNSTRUCTURED_PAGE, i),
                ))

    def _read_structured(self, filename: str, data: bytes,
                         mime: Optional[str] = None):
        import pandas as pd

        name = filename.lower()
        mime = mime or ""
        try:
            if name.endswith((".csv", ".tsv")) or "csv" in mime:
                if name.endswith(".tsv"):
                    sep = "\t"
                elif name.endswith(".csv"):
                    sep = ","
                else:
                    # sniffed CSV: the content heuristic accepts , \t ;
                    # so let pandas infer the delimiter (csv.Sniffer)
                    sep = None
                df = pd.read_csv(io.BytesIO(data), sep=sep,
                                 engine="python" if sep is None else "c")
                return [(filename.rsplit("/", 1)[-1], df)]
            if name.endswith((".xlsx", ".xls")) or "spreadsheet" in mime:
                book = pd.read_excel(io.BytesIO(data), sheet_name=None)
                return list(book.items())
            if name.endswith(".parquet") or "parquet" in mime:
                return [(filename, pd.read_parquet(io.BytesIO(data)))]
        except pd.errors.EmptyDataError as e:
            raise NonRetryableError(f"empty sheet: {e}") from e
        raise NonRetryableError(f"unsupported structured format: {filename}")

    def _split_unstructured(self, filename: str, data: bytes) -> List[Dict]:
        """Page split by content type — all native, no external
        converters (parity: pypdf page split + markitdown text,
        IndexerAPI file_processor.py:150-184, utils.py:16-22):

          PDF   -> ingest/pdf.py (xref/page-tree/content-stream parse)
          docx/pptx -> ingest/office.py (zip + XML)
          text  -> paged by the chunk budget

        Undecodable binary fails loudly into the ledger instead of
        indexing replacement-character soup."""
        from . import office, pdf

        if pdf.is_pdf(data):
            try:
                doc = pdf.PDFDocument(data)  # one parse serves text+images
                texts = pdf.extract_pages(data, doc)
            except pdf.PDFError as e:
                raise NonRetryableError(f"PDF parse failed: {e}") from e
            pages = [{"text": t} for t in texts]
            if self.pdf_rasterizer is not None and self.page_describer is not None:
                for i, page in enumerate(pages):
                    try:
                        page["image"] = self.pdf_rasterizer(data, i + 1)
                    except Exception:  # rasterize is best-effort
                        pass
            # Scanned pages carry their raster as an embedded XObject
            # image — recover it natively (DCTDecode IS a JPEG file;
            # Flate rasters wrap into PNG) so the VLM flow needs no
            # external renderer (parity: pdf2image, utils.py:16-22)
            if not all(texts) and (self.page_describer is not None
                                   or not any(texts)):
                try:
                    images = pdf.extract_page_images(data, doc)
                except Exception:
                    images = []
                for page, img in zip(pages, images):
                    if (not page["text"] and img is not None
                            and page.get("image") is None):
                        page["image"] = img[1]
            if not any(p["text"] or p.get("image") is not None
                       for p in pages):
                raise NonRetryableError(
                    "PDF has no extractable text and no convertible page "
                    "images (symbol-coded JBIG2 scan?); configure a "
                    "pdf_rasterizer hook")
            if (not any(texts) and self.page_describer is None):
                raise NonRetryableError(
                    "PDF is image-only; a page_describer (VLM hook) is "
                    "required to ingest it")
            return pages

        kind = office.ooxml_kind(data)
        if kind in ("docx", "pptx"):
            try:
                return [{"text": t} for t in office.extract_pages(data)]
            except office.OfficeError as e:
                raise NonRetryableError(
                    f"{kind} parse failed: {e}") from e

        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError as e:
            if data[:2] in (b"\xff\xfe", b"\xfe\xff"):
                text = data.decode("utf-16", errors="replace")
            else:
                raise NonRetryableError(
                    f"binary payload {filename!r} is not a supported "
                    "document format (pdf/docx/pptx/text); configure a "
                    "converter hook") from e
        pages = chunk_words(text, self.cfg.chunk_chars)
        return [{"text": t} for t in pages]

    async def _handle_direct_chunk(self, task: Task) -> None:
        p = task.payload
        text = p["text"]
        ctx = p.get("context", "")
        # context prepended for embedding (parity: contextualized chunk
        # embeddings, text_processor.py:311-333), raw text kept for display
        embed_text = f"{ctx}\n\n{text}" if ctx else text
        kg_data = await self._extract_kg(text)
        emb = await asyncio.to_thread(self.embedder.encode, [embed_text])
        self.collection.store_document_vectors(
            p["document_id"],
            [{"text": text, "context": ctx,
              "chunk_index": p["chunk_index"], "source": "direct"}],
            emb,
        )
        await self._store_kg(p["document_id"], p["chunk_index"], text,
                             kg_data, emb[0])

    async def _handle_unstructured_page(self, task: Task) -> None:
        p = task.payload
        if "text_key" in p:
            # object-store handoff: re-read the page payload; a missing
            # key is non-retryable (parity: NoSuchKey fast path,
            # rabbitmq_handler.py:37-63)
            from ..store.objects import NoSuchKeyError

            try:
                text = (await self.object_store.aget_object(p["text_key"])
                        ).decode("utf-8")
                image = (await self.object_store.aget_object(p["image_key"])
                         if "image_key" in p else None)
            except NoSuchKeyError as e:
                raise NonRetryableError(f"missing page object: {e}") from e
        else:
            text = p["text"]
            image = p.get("image")
        if image is not None and self.page_describer is not None:
            if asyncio.iscoroutinefunction(self.page_describer):
                desc = await self.page_describer(image)
            else:
                desc = await asyncio.to_thread(self.page_describer, image)
            text = f"{text}\n\n{desc}" if text else desc
        elif (image is not None
              and getattr(self.embedder, "supports_images", False)):
            # no VLM configured: decode the raster natively (PNG or
            # baseline JPEG — models/image.py dispatch) and embed the
            # pixels through the multimodal tower, the audio-chunk
            # pattern applied to vision (parity: ImageBind image
            # modality, imagebind_handler.py:23-32). MJPEG video frames
            # take exactly this path.
            from ..models.image import ImageError, image_to_input

            try:
                raster = await asyncio.to_thread(
                    image_to_input, image,
                    self.embedder.state.model.image_size)
            except ImageError as e:
                if not text:
                    raise NonRetryableError(
                        f"image page {p['page_number']} is not natively "
                        f"decodable ({e}); configure a page_describer "
                        "hook") from e
                raster = None
            if raster is not None:
                display = text or f"[image] page {p['page_number']}"
                emb = await asyncio.to_thread(
                    self.embedder.encode_image, raster[None],
                    [text] if text else None)
                kg_data = await self._extract_kg(text)
                self.collection.store_document_vectors(
                    p["document_id"],
                    [{"text": display, "page_number": p["page_number"],
                      "source": "unstructured"}],
                    emb,
                )
                await self._store_kg(p["document_id"], p["page_number"],
                                     text, kg_data, emb[0])
                return
        kg_data = await self._extract_kg(text)
        emb = await asyncio.to_thread(self.embedder.encode, [text])
        self.collection.store_document_vectors(
            p["document_id"],
            [{"text": text, "page_number": p["page_number"],
              "source": "unstructured"}],
            emb,
        )
        await self._store_kg(p["document_id"], p["page_number"], text,
                             kg_data, emb[0])

    async def _handle_audio_chunk(self, task: Task) -> None:
        """Audio file -> log-mel features -> multimodal-tower embedding
        (parity: ImageBind audio modality, imagebind_handler.py:23-32;
        the reference's AudioProcessor stub returns None — here the clip
        becomes a searchable chunk)."""
        from ..models import audio as audio_mod

        p = task.payload
        data = p["data"]

        def features() -> np.ndarray:
            if self.audio_decoder is not None:
                wave, sr = self.audio_decoder(data)
                m = audio_mod.log_mel(np.asarray(wave, np.float32), int(sr))
                n = audio_mod.N_FRAMES
                m = (m[:n] if m.shape[0] >= n
                     else np.pad(m, ((0, n - m.shape[0]), (0, 0))))
                return ((m - m.mean()) / max(float(m.std()), 1e-6)
                        ).astype(np.float32)
            return audio_mod.wav_to_features(data)

        try:
            feats = await asyncio.to_thread(features)
        except ValueError as e:
            raise NonRetryableError(
                f"cannot decode audio {p['filename']!r} natively ({e}); "
                "configure an audio_decoder hook") from e
        text = ""
        if self.audio_transcriber is not None:
            text = await asyncio.to_thread(self.audio_transcriber, data)
        emb = await asyncio.to_thread(
            self.embedder.encode_audio, feats[None],
            [text] if text else None)
        display = text or f"[audio] {p['filename']}"
        self.collection.store_document_vectors(
            p["document_id"],
            [{"text": display, "source": "audio", "page_number": 1,
              "filename": p["filename"]}],
            emb,
        )
        if text:
            kg_data = await self._extract_kg(text)
            await self._store_kg(p["document_id"], 1, text, kg_data, emb[0])

    async def _handle_structured_chunk(self, task: Task) -> None:
        p = task.payload
        df = p["records"]
        if len(df.columns) == 0:
            raise NonRetryableError("sheet has no columns")
        # table summary: schema + sample rows (parity: 20-row markdown
        # sample, _structured_processor.py:46-108)
        sample = df.head(20)
        summary = (
            f"Sheet {p['sheet_name']} with {len(df)} rows. Columns: "
            + ", ".join(str(c) for c in df.columns)
            + ". Sample: "
            + "; ".join(
                " | ".join(str(v) for v in row) for row in sample.values[:5]
            )
        )
        emb = await asyncio.to_thread(self.embedder.encode, [summary])
        self.collection.store_document_vectors(
            p["document_id"],
            [{"text": summary, "sheet_name": p["sheet_name"],
              "page_number": p["sheet_index"] + 1, "source": "structured"}],
            emb,
        )
        if self.kg is not None:
            col_profiles = [
                {"name": str(c),
                 "profile": f"column {c} of {p['sheet_name']}, "
                            f"dtype {df[c].dtype}, "
                            f"{df[c].nunique()} unique values"}
                for c in df.columns
            ]
            col_embs = await asyncio.to_thread(
                self.embedder.encode, [c["profile"] for c in col_profiles]
            )
            self.kg.upsert_structured_sheet(
                p["document_id"], p["sheet_index"] + 1,
                sheet_name=p["sheet_name"], summary=summary,
                summary_embedding=self._kg_vec(emb[0]),
                columns=col_profiles,
                column_embeddings=np.stack([self._kg_vec(v) for v in col_embs]),
                rows=df.head(200).to_dict("records"),
            )

    # ------------------------------------------------------------------ kg

    async def _extract_kg(self, text: str):
        if self.kg is None or self.kg_extractor is None:
            return None
        if asyncio.iscoroutinefunction(self.kg_extractor):
            return await self.kg_extractor(text)
        return await asyncio.to_thread(self.kg_extractor, text)

    def _kg_vec(self, v: np.ndarray) -> np.ndarray:
        """Project an embedding into the KG's dimension (parity: the v1
        256-d truncation, entity_relation_extractor.py:251)."""
        dim = self.kg.dim
        if len(v) >= dim:
            return np.asarray(v[:dim], dtype=np.float32)
        return np.pad(np.asarray(v, dtype=np.float32), (0, dim - len(v)))

    async def _store_kg(self, document_id: str, page_number: int, text: str,
                        kg_data, page_vec: np.ndarray) -> None:
        if self.kg is None:
            return
        entities = relationships = ()
        e_embs = r_embs = None
        if kg_data:
            entities = kg_data.get("entities", ())
            relationships = kg_data.get("relationships", ())
            if entities:
                texts = [
                    f"{e.get('text', '')} {e.get('entity_type', '')} "
                    f"{e.get('entity_profile', '')}"
                    for e in entities
                ]
                vecs = await asyncio.to_thread(self.embedder.encode, texts)
                e_embs = np.stack([self._kg_vec(v) for v in vecs])
            if relationships:
                texts = [r.get("relationship_profile", "") for r in relationships]
                vecs = await asyncio.to_thread(self.embedder.encode, texts)
                r_embs = np.stack([self._kg_vec(v) for v in vecs])
        self.kg.upsert_unstructured_page(
            document_id, page_number, content=text,
            embedding=self._kg_vec(page_vec),
            entities=entities, relationships=relationships,
            entity_embeddings=e_embs, relationship_embeddings=r_embs,
        )
