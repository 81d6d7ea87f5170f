"""The service surface: every reference endpoint on the native engine.

Port of `rag_application_tpu/api/app.py`: the reference's routes over
the port's stores, with a `device=` on `build_app` (``cuda`` unless the
caller names another) that every user space, restored space and the
default `Embedder` is built on. The rest is the reference's code.

Parity map:
  POST /ingest/file          IndexerAPI ingest.py:12-30 (file -> queue ->
                             fan-out pipeline)
  POST /ingest/raw-text      ingest.py:44-54
  POST /search/scout         IndexerAPI search.py:60-86 (embed + 4-space kNN)
  POST /search/query         search.py:43-58 — the raw-Cypher passthrough,
                             here a typed structured-query surface
  POST /delete/file          delete.py:10-60 (graph + chunk cascade)
  GET  /queue/info           rabbitmq_handler.py:248-262
  POST /api/v1/query/ask     app/api/v1/endpoints/query.py:19-35 ->
                             QueryProcessor.process_query (orchestrated
                             search + grounded answer)
  POST /api/v1/search/hybrid the monolith's MCP search surface
                             (qdrant_search_mcp_endpoint.py:21-34)
  POST /chat/completions     AgentAPI chat.py — OpenAI-compatible, SSE
                             streaming, agent with knowledge tools
  GET  /v1/models            ModelRouterAPI models endpoint
  GET  /health               every service's health route

Auth: optional bearer token (parity: ModelRouterAPI API-key middleware,
main.py:17-45).
"""

from __future__ import annotations

import base64
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..agents.base_agent import BaseAgent
from ..agents.memory import ThreadCheckpointer, VectorMemoryStore
from ..config import Config
from ..ingest.pipeline import IngestPipeline
from ..kg.store import KGStore
from ..llm.router import LLMRouter
from ..models.embedder import Embedder
from ..search.orchestration import SearchOrchestrator
from ..store.collection import Collection
from ..tools.knowledge import KnowledgeSearchToolbox
from ..utils.runtime import DeviceLike, resolve_device
from .http import JSONResponse, Request, Router, SSEResponse

RAG_SYSTEM_PROMPT = (
    "You are a retrieval-grounded assistant. Answer ONLY from the provided "
    "context. If the context does not contain the answer, say you do not "
    "know. Cite document ids."
)


@dataclass
class UserSpace:
    collection: Collection
    kg: KGStore
    pipeline: IngestPipeline
    batcher: Optional[object] = None  # lazy MicroBatcher (search/batcher.py)

    def get_batcher(self, embedder):
        """Per-space request micro-batcher: concurrent /search/hybrid
        requests ride ONE encode + ONE engine dispatch
        (see search/batcher.py)."""
        if self.batcher is None:
            import os

            from ..search.batcher import MicroBatcher

            col = self.collection
            # RAGTPU_TOKENS_WIRE=1: text requests skip the host-side
            # encode — token ids upload and the device runs encoder
            # forward + funnel in ONE dispatch (collection
            # hybrid_search_text_batch; result-identical to
            # encode-then-search)
            tokens_wire = os.environ.get("RAGTPU_TOKENS_WIRE", "0") == "1"
            if tokens_wire:
                col.bind_query_encoder(embedder)

            def run(embs, texts, limit):
                if embs is None and tokens_wire:
                    return col.hybrid_search_text_batch(texts, limit)
                if embs is None:
                    embs = embedder.encode(texts)
                return col.hybrid_search_batch(embs, texts, limit)

            self.batcher = MicroBatcher(
                run,
                max_batch=int(os.environ.get("RAGTPU_MICROBATCH_MAX", 256)),
                max_wait_ms=float(
                    os.environ.get("RAGTPU_MICROBATCH_WAIT_MS", 2.0)),
            )
        return self.batcher


@dataclass
class AppState:
    config: Config
    embedder: Embedder
    llm: LLMRouter
    api_key: Optional[str] = None
    users: Dict[str, UserSpace] = field(default_factory=dict)
    checkpointer: ThreadCheckpointer = field(default_factory=ThreadCheckpointer)
    memory: Optional[VectorMemoryStore] = None
    # LLM-in-the-loop ingest stages (parity: per-page KG extraction +
    # VLM description, _unstructured_processor.py:44-66) — optional so
    # the engine serves without network dependencies
    kg_extractor: Optional[Any] = None
    page_describer: Optional[Any] = None
    # the device every user space's Collection and KGStore lives on
    device: Optional[torch.device] = None

    @staticmethod
    def _fs_safe(user_id: str) -> str:
        """Filesystem-safe user directory name: user_id comes from the
        request body, so 'x/../../etc' must never influence a path (the
        object-store delete cascade rmtree's under this root). Unsafe
        ids get a collision-proof digest suffix."""
        import hashlib
        import re

        safe = re.sub(r"[^\w.-]", "_", user_id)
        if safe != user_id or safe in ("", ".", ".."):
            safe = f"{safe[:32]}_{hashlib.sha256(user_id.encode()).hexdigest()[:12]}"
        return safe

    def make_pipeline(self, user_id: str, col: Collection,
                      kg: KGStore) -> IngestPipeline:
        """Pipeline wiring shared by space() and /admin/restore (a
        restored space must get the same object_store + url_fetcher)."""
        objects = None
        if self.config.ingest.object_store_dir:
            from ..store.objects import ObjectStore

            objects = ObjectStore(
                os.path.join(self.config.ingest.object_store_dir,
                             f"user_{self._fs_safe(user_id)}"))
        from ..tools.web import make_http_fetch_backend

        return IngestPipeline(col, self.embedder, kg=kg,
                              kg_extractor=self.kg_extractor,
                              page_describer=self.page_describer,
                              object_store=objects,
                              url_fetcher=make_http_fetch_backend(),
                              config=self.config.ingest)

    def space(self, user_id: str) -> UserSpace:
        if user_id not in self.users:
            col = Collection(f"user_{user_id}", self.config,
                             device=self.device)
            kg = KGStore(self.config.kg, dim=min(self.embedder.dim, 2048),
                         scope={"user_id": user_id}, device=self.device)
            pipe = self.make_pipeline(user_id, col, kg)
            self.users[user_id] = UserSpace(col, kg, pipe)
        return self.users[user_id]


def build_app(config: Optional[Config] = None, *,
              llm: Optional[LLMRouter] = None,
              embedder: Optional[Embedder] = None,
              api_key: Optional[str] = None,
              kg_extractor=None,
              page_describer=None,
              device: DeviceLike = None):
    """Returns (router, state). Serve with HTTPServer(router). The user
    spaces (and the default embedder) live on ``device``: ``cuda``
    unless the caller names another."""
    device = resolve_device(device)
    config = config or Config()
    embedder = embedder or Embedder(cfg=config.encoder, device=device)
    llm = llm or LLMRouter()
    state = AppState(config=config, embedder=embedder, llm=llm,
                     api_key=api_key,
                     memory=VectorMemoryStore(embedder),
                     kg_extractor=kg_extractor,
                     page_describer=page_describer,
                     device=device)
    router = Router()

    def _auth(req: Request) -> Optional[JSONResponse]:
        """Bearer auth: the global api_key OR a user signin token (the
        tokens /api/v1/users/signin issues must actually open doors)."""
        if state.api_key is None:
            return None
        tok = req.headers.get("authorization", "")
        if tok == f"Bearer {state.api_key}":
            return None
        reg = getattr(state, "user_registry", None)
        if (reg is not None and tok.startswith("Bearer ")
                and reg.verify_token(tok[len("Bearer "):])):
            return None
        return JSONResponse({"detail": "unauthorized"}, 401)

    # ------------------------------------------------------------- health

    @router.route("GET", "/health")
    async def health(req: Request):
        return {"status": "ok", "users": len(state.users)}

    @router.route("GET", "/metrics")
    async def metrics(req: Request):
        from ..utils.observability import METRICS
        from .http import Response

        return Response(headers={"content-type": "text/plain; version=0.0.4"},
                        body=METRICS.render().encode())

    @router.route("GET", "/chat")
    async def chat_page(req: Request):
        """L7: the single-file chat frontend (api/chat_ui.py) — parity
        with AgentChatUI at the same API boundary (the page itself is
        public; every API call it makes carries the bearer key)."""
        from .chat_ui import CHAT_HTML
        from .http import Response

        return Response(headers={"content-type": "text/html; charset=utf-8"},
                        body=CHAT_HTML.encode())

    @router.route("GET", "/v1/models")
    async def models(req: Request):
        return {"object": "list", "data": [
            {"id": state.llm.model, "object": "model",
             "owned_by": state.llm.provider.value},
            {"id": "rag-tpu-encoder", "object": "model", "owned_by": "local"},
        ]}

    # -------------------------------------------------------------- ingest

    @router.route("POST", "/ingest/file")
    async def ingest_file(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        user_id = body.get("user_id", "default")
        filename = body["filename"]
        if "content_b64" in body:
            data = base64.b64decode(body["content_b64"])
        elif "text" in body:
            data = body["text"].encode()
        else:
            return JSONResponse({"detail": "content_b64 or text required"}, 422)
        sp = state.space(user_id)
        result = await sp.pipeline.ingest_file(
            filename, data, document_id=body.get("document_id"))
        return JSONResponse({
            "status": "accepted",
            "document_id": result.document_id,
            "chunks": result.chunks,
            "pages": result.pages,
            "failed_tasks": result.failed_tasks,
        }, 202)

    @router.route("POST", "/ingest/raw-text")
    async def ingest_text(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        result = await sp.pipeline.ingest_text(
            body["text"], document_id=body.get("document_id", uuid.uuid4().hex))
        return JSONResponse({"status": "accepted",
                             "document_id": result.document_id,
                             "chunks": result.chunks}, 202)

    @router.route("POST", "/ingest/url")
    async def ingest_url(req: Request):
        """Parity surface: POST /ingest/url (IndexerAPI ingest.py:32-42) —
        and unlike the reference (whose URL task raises
        NotImplementedError, orchestrator.py:24-27) this one works."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        result = await sp.pipeline.ingest_url(
            body["url"], document_id=body.get("document_id"))
        return JSONResponse({"status": "accepted",
                             "document_id": result.document_id,
                             "chunks": result.chunks,
                             "failed_tasks": result.failed_tasks}, 202)

    @router.route("POST", "/delete/file")
    async def delete_file(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        removed = sp.collection.delete_document(body["document_id"])
        kg_removed = sp.kg.delete_document(body["document_id"])
        objects_removed = 0
        if sp.pipeline.object_store is not None:
            # graph + chunk + object cascade (parity: delete.py:10-60)
            objects_removed = await sp.pipeline.object_store.adelete_prefix(
                body["document_id"])
        return {"deleted_chunks": removed, "deleted_graph_nodes": kg_removed,
                "deleted_objects": objects_removed}

    @router.route("GET", "/queue/info")
    async def queue_info(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        return {u: sp.pipeline.queue.queue_info()
                for u, sp in state.users.items()}

    # ------------------------------------------------------------------ ANN

    @router.route("POST", "/admin/build-ann")
    async def admin_build_ann(req: Request):
        """Build the sublinear ANN engine over a user space (IVF by
        default — docs/ann.md; `probes` at query time parities hnsw_ef,
        qdrant_handler.py:369). Build runs in an executor: device
        k-means is seconds, but the event loop keeps serving."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        kw = {k: int(v) for k, v in body.items()
              if k in ("n_clusters", "bucket_rows", "iters",
                       "train_sample")}
        engine = body.get("engine", "ivf")
        if engine != "ivf":
            return JSONResponse({"detail": "unknown engine (use 'ivf')"}, 400)
        import asyncio as _asyncio

        await _asyncio.get_running_loop().run_in_executor(
            None, lambda: sp.collection.build_ann(engine=engine, **kw))
        ann = sp.collection.ann
        info = {"engine": engine, "rows": sp.collection.dense.size}
        if hasattr(ann, "bucket_tbl"):
            info.update(buckets=int(ann.bucket_tbl.shape[0]),
                        clusters=int(ann.centroids.shape[0]))
        return info

    @router.route("POST", "/api/v1/search/ann")
    async def search_ann(req: Request):
        """Sublinear ANN query (the hnsw_ef-style strict-latency path;
        build first via /admin/build-ann)."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        if getattr(sp.collection, "ann", None) is None:
            return JSONResponse(
                {"detail": "no ANN index: POST /admin/build-ann first"}, 400)
        import asyncio as _asyncio

        q = (await _asyncio.get_running_loop().run_in_executor(
            None, state.embedder.encode, [body["query"]]))[0]
        hits = sp.collection.ann_search(
            q, limit=body.get("limit", 10), ef=int(body.get("ef", 128)),
            **(body.get("filters") or {}))
        return {"results": [
            {"score": h.score, "payload": h.payload} for h in hits]}

    # ----------------------------------------------------------- durability

    @router.route("POST", "/admin/checkpoint")
    async def admin_checkpoint(req: Request):
        """Persist a user space (chunk index + KG) to a directory — the
        framework-owned durability the reference delegates to docker
        volumes (SURVEY §5.4)."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        import os

        from ..index.checkpoint import save_collection
        from ..kg.checkpoint import save_kg

        sp = state.space(body.get("user_id", "default"))
        path = body["path"]
        os.makedirs(path, exist_ok=True)
        save_collection(sp.collection, os.path.join(path, "collection"))
        save_kg(sp.kg, os.path.join(path, "kg"))
        return {"saved": path,
                "chunks": sp.collection.chunk_count(),
                "kg": sp.kg.stats()}

    @router.route("POST", "/admin/restore")
    async def admin_restore(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        import os

        from ..index.checkpoint import load_collection
        from ..ingest.pipeline import IngestPipeline
        from ..kg.checkpoint import load_kg

        user_id = body.get("user_id", "default")
        path = body["path"]
        col = load_collection(os.path.join(path, "collection"), state.config,
                              device=state.device)
        kg = load_kg(os.path.join(path, "kg"), state.config.kg,
                     device=state.device)
        # same wiring as a fresh space: object store + URL fetcher
        pipe = state.make_pipeline(user_id, col, kg)
        state.users[user_id] = UserSpace(col, kg, pipe)
        return {"restored": path, "chunks": col.chunk_count(),
                "kg": kg.stats()}

    # ----------------------------------------------------- chunked upload

    _uploads: Dict[str, Dict[str, Any]] = {}

    @router.route("POST", "/api/v1/upload/start")
    async def upload_start(req: Request):
        """Chunked upload protocol (parity: approval ids + chunks +
        completion, app/api/v1/endpoints/upload.py:8-55)."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        approval_id = uuid.uuid4().hex
        _uploads[approval_id] = {"filename": body["filename"],
                                 "user_id": body.get("user_id", "default"),
                                 "chunks": {}}
        return JSONResponse({"approval_id": approval_id}, 202)

    @router.route("POST", "/api/v1/upload/chunk/{approval_id}/{index}")
    async def upload_chunk(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        up = _uploads.get(req.params["approval_id"])
        if up is None:
            return JSONResponse({"detail": "unknown approval id"}, 404)
        up["chunks"][int(req.params["index"])] = req.body
        return {"received": len(req.body)}

    @router.route("POST", "/api/v1/upload/complete/{approval_id}")
    async def upload_complete(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        up = _uploads.pop(req.params["approval_id"], None)
        if up is None:
            return JSONResponse({"detail": "unknown approval id"}, 404)
        # chunks must form a contiguous 0..n-1 sequence: a silently
        # dropped chunk would otherwise index truncated content
        got = sorted(up["chunks"])
        if got != list(range(len(got))) or not got:
            _uploads[req.params["approval_id"]] = up  # let the client retry
            return JSONResponse(
                {"detail": f"missing chunks: have {got}"}, 422)
        data = b"".join(up["chunks"][i] for i in got)
        sp = state.space(up["user_id"])
        result = await sp.pipeline.ingest_file(up["filename"], data)
        return JSONResponse({"document_id": result.document_id,
                             "chunks": result.chunks}, 202)

    @router.route("POST", "/webhook/storage")
    async def storage_webhook(req: Request):
        """S3-style object-created webhook (parity: the MinIO webhook ->
        priority queue, app/api/v1/endpoints/minio_webhook.py:12-90).
        Accepts inline content or a local path inside the records."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        accepted = []
        for record in body.get("Records", []):
            key = record.get("s3", {}).get("object", {}).get("key", "")
            user_id = record.get("user_id", "default")
            content = record.get("content")
            if content is None:
                continue  # no external object store in-process
            sp = state.space(user_id)
            result = await sp.pipeline.ingest_file(
                key, content.encode() if isinstance(content, str)
                else base64.b64decode(content.get("b64", "")))
            accepted.append(result.document_id)
        return JSONResponse({"accepted": accepted}, 202)

    # -------------------------------------------------------- users/agents

    from .users import AgentConfigRegistry, UserRegistry

    state.user_registry = UserRegistry()
    state.agent_registry = AgentConfigRegistry()

    @router.route("POST", "/api/v1/users/signup")
    async def signup(req: Request):
        # when a global api key is configured, only the key holder may
        # mint accounts: an open signup would let anyone create a token
        # that _auth accepts, bypassing the key entirely. (User tokens
        # don't qualify either — accounts create accounts is the same
        # hole one hop later.)
        if state.api_key is not None:
            tok = req.headers.get("authorization", "")
            if tok != f"Bearer {state.api_key}":
                return JSONResponse({"detail": "unauthorized"}, 401)
        body = req.json()
        try:
            user = state.user_registry.signup(
                body["username"], body["password"], body.get("email", ""))
        except ValueError as e:
            return JSONResponse({"detail": str(e)}, 422)
        return JSONResponse(user, 201)

    @router.route("POST", "/api/v1/users/signin")
    async def signin(req: Request):
        body = req.json()
        token = state.user_registry.signin(body.get("username", ""),
                                           body.get("password", ""))
        if token is None:
            return JSONResponse({"detail": "invalid credentials"}, 401)
        return {"access_token": token, "token_type": "bearer"}

    @router.route("GET", "/api/v1/users")
    async def list_users(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        return {"users": state.user_registry.list()}

    @router.route("GET", "/api/v1/users/{user_id}")
    async def get_user(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        user = state.user_registry.get(req.params["user_id"])
        return user or JSONResponse({"detail": "not found"}, 404)

    @router.route("PUT", "/api/v1/users/{user_id}")
    async def update_user(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        user = state.user_registry.update(req.params["user_id"],
                                          **(req.json() or {}))
        return user or JSONResponse({"detail": "not found"}, 404)

    @router.route("DELETE", "/api/v1/users/{user_id}")
    async def delete_user(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        ok = state.user_registry.delete(req.params["user_id"])
        return ({"deleted": True} if ok
                else JSONResponse({"detail": "not found"}, 404))

    @router.route("POST", "/api/v1/agents")
    async def create_agent(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        try:
            cfg = state.agent_registry.create(
                body["name"], base=body.get("base", "chat_agent"),
                system_prompt=body.get("system_prompt", ""),
                capabilities=body.get("capabilities"))
        except ValueError as e:
            return JSONResponse({"detail": str(e)}, 422)
        return JSONResponse(cfg, 201)

    @router.route("GET", "/api/v1/agents")
    async def list_custom_agents(req: Request):
        return {"agents": state.agent_registry.list()}

    @router.route("PUT", "/api/v1/agents/{agent_id}")
    async def update_agent(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        cfg = state.agent_registry.update(req.params["agent_id"],
                                          **(req.json() or {}))
        return cfg or JSONResponse({"detail": "not found"}, 404)

    @router.route("DELETE", "/api/v1/agents/{agent_id}")
    async def delete_agent(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        ok = state.agent_registry.delete(req.params["agent_id"])
        return ({"deleted": True} if ok
                else JSONResponse({"detail": "not found"}, 404))

    @router.route("GET", "/v1/tools")
    async def list_tools(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        """Parity: AgentAPI tools route (api/routes/tools.py)."""
        sp = state.space(req.query.get("user_id", "default"))
        toolbox = KnowledgeSearchToolbox(sp.collection, sp.kg,
                                         state.embedder).build()
        return {"tools": toolbox.names()}

    # ------------------------------------------------------------ catalog

    @router.route("GET", "/agents")
    async def agents_catalog(req: Request):
        """Agent catalog (parity: AGENT_CATALOG with capability toggles,
        AgentAPI backend/agents/catalog.py:26-84)."""
        from ..agents import AGENT_CLASS_MAP, _register_builtin

        _register_builtin()
        return {"agents": [
            {"id": aid, "class": cls.__name__,
             "capabilities": {"tools": True, "memory": True,
                              "streaming": hasattr(cls, "astream")}}
            for aid, cls in sorted(AGENT_CLASS_MAP.items())]}

    def _doc_counts(user_id: str) -> Dict[str, int]:
        # read-only: never allocate a fresh space for an unknown user
        # (a lookup loop over random ids would grow state.users
        # unboundedly — same guard as collection_count)
        if user_id not in state.users:
            return {}
        sp = state.users[user_id]
        docs: Dict[str, int] = {}
        for row in range(len(sp.collection.payloads)):
            p = sp.collection.payloads.get(row)
            if p is not None:
                did = p.get("document_id", "?")
                docs[did] = docs.get(did, 0) + 1
        return docs

    @router.route("GET", "/api/v1/collections")
    async def list_collections(req: Request):
        """Parity: MCP GET /collections (qdrant_search_mcp_endpoint.py:102
        get_all_collections) — every registered user space."""
        return {"collections": [
            {"user_id": uid, "chunks": sp.collection.chunk_count()}
            for uid, sp in sorted(state.users.items())]}

    @router.route("GET", "/api/v1/collections/{user_id}/count")
    async def collection_count(req: Request):
        """Parity: MCP GET /collections/{user_id}/count
        (qdrant_search_mcp_endpoint.py:120-151). Query-string params are
        equality payload filters (e.g. ?kind=chat&document_id=x) — the
        filtered count the reference stubs out (its `filters` plumbing is
        commented out; the Qdrant handler supports it,
        qdrant_handler.py:443-480)."""
        uid = req.params["user_id"]
        if uid not in state.users:
            return {"user_id": uid, "chunks": 0}
        filters = dict(req.query)
        return {"user_id": uid,
                "chunks": state.users[uid].collection.chunk_count(**filters)}

    @router.route("GET", "/api/v1/documents")
    async def list_documents(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        docs = _doc_counts(req.query.get("user_id", "default"))
        return {"documents": [
            {"document_id": d, "chunks": c} for d, c in sorted(docs.items())]}

    @router.route("GET", "/api/v1/documents/{document_id}")
    async def get_document(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        user_id = req.query.get("user_id", "default")
        did = req.params["document_id"]
        docs = _doc_counts(user_id)
        if did not in docs:
            return JSONResponse({"detail": "not found"}, 404)
        sp = state.users[user_id]
        meta = sp.kg.get_document(did) or {}
        return {"document_id": did, "chunks": docs[did],
                "pages": len(sp.kg.get_pages(did)), **meta}

    @router.route("DELETE", "/api/v1/documents/{document_id}")
    async def delete_document_rest(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        user_id = req.query.get("user_id", "default")
        did = req.params["document_id"]
        sp = state.space(user_id)
        if did not in _doc_counts(user_id):
            return JSONResponse({"detail": "not found"}, 404)  # no mutation
        removed = sp.collection.delete_document(did)
        sp.kg.delete_document(did)
        if sp.pipeline.object_store is not None:
            await sp.pipeline.object_store.adelete_prefix(did)
        return {"deleted_chunks": removed}

    # ---------------------------------------------- LLM passthrough (v1)

    @router.route("POST", "/v1/chat/completions")
    async def llm_passthrough(req: Request):
        """Direct provider passthrough (parity: ModelRouterAPI chat
        endpoint, api/v1/endpoints/chat.py:24-100) — no agent loop."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        from ..llm.router import ChatMessage

        msgs = [ChatMessage(m.get("role", "user"), m.get("content") or "")
                for m in body.get("messages", [])]
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        model = body.get("model", state.llm.model)
        # forward the standard sampling params (parity: ModelRouterAPI
        # chat.py:24-100 passes the request's generation knobs through);
        # the router's per-provider allowlist filters them
        gen = {k: body[k] for k in (
            "temperature", "max_tokens", "top_p", "stop", "seed",
            "logprobs", "presence_penalty", "frequency_penalty",
            "logit_bias",
            "adapter")  # extension: named LoRA adapter (local provider)
            if k in body}
        # OpenAI structured output (parity: openai.py:115-166 routes
        # response_format server-side): json_schema unwraps to the raw
        # schema; the local provider enforces it with an on-chip DFA
        # when compilable, every provider gets the instruction fallback
        rf = body.get("response_format") or {}
        if rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema",
                                                       rf.get("schema"))
            if schema:
                gen["response_schema"] = schema
        if body.get("stream"):
            async def events():
                async for delta in state.llm.stream(msgs, **gen):
                    yield {"id": completion_id,
                           "object": "chat.completion.chunk",
                           "created": int(time.time()), "model": model,
                           "choices": [{"index": 0,
                                        "delta": {"content": delta},
                                        "finish_reason": None}]}
                yield {"id": completion_id,
                       "object": "chat.completion.chunk",
                       "created": int(time.time()), "model": model,
                       "choices": [{"index": 0, "delta": {},
                                    "finish_reason": "stop"}]}
            return SSEResponse(events())
        resp = await state.llm.chat(msgs, **gen)
        choice = {"index": 0, "message": {
            "role": "assistant", "content": resp.content},
            "finish_reason": "stop"}
        if getattr(resp, "logprobs", None) is not None:
            choice["logprobs"] = {"content": resp.logprobs}
        return {"id": completion_id, "object": "chat.completion",
                "created": int(time.time()), "model": model,
                "choices": [choice], "usage": resp.usage}

    # -------------------------------------------------------------- search

    @router.route("POST", "/search/scout")
    async def scout(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        import asyncio as _asyncio

        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        # encoder off the event loop (first call pays the remote
        # compile; inline it would freeze every concurrent request)
        q = (await _asyncio.get_running_loop().run_in_executor(
            None, state.embedder.encode, [body["query"]]))[0][: sp.kg.dim]
        hits = sp.kg.search_across_spaces(q, k=body.get("k", 10))
        return {"results": hits}

    @router.route("POST", "/search/query")
    async def structured_query(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        toolbox = KnowledgeSearchToolbox(sp.collection, sp.kg,
                                         state.embedder).build()
        t = toolbox.get(body["tool"])
        if t is None:
            return JSONResponse(
                {"detail": f"unknown tool; available: {toolbox.names()}"}, 422)
        result = await t.call(**body.get("args", {}))
        return {"result": result}

    @router.route("POST", "/api/v1/search/hybrid")
    async def hybrid(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        filters = body.get("filters") or {}
        if filters:
            # filtered searches skip the micro-batcher: the engine mask is
            # per-request, and grouping requests with different masks onto
            # one dispatch would cross-contaminate results (the reference
            # routes filters straight to Qdrant too,
            # qdrant_handler.py:297). Equality-on-payload-field semantics.
            import asyncio as _asyncio

            loop = _asyncio.get_running_loop()
            q = (await loop.run_in_executor(
                None, state.embedder.encode, [body["query"]]))[0]
            hits = await loop.run_in_executor(
                None, lambda: sp.collection.hybrid_search(
                    q, body["query"], body.get("limit", 10), **filters))
        else:
            # concurrent requests micro-batch onto ONE encoder forward +
            # ONE engine dispatch (embedding=None -> the batcher encodes)
            hits = await sp.get_batcher(state.embedder).search(
                None, body["query"], body.get("limit", 10))
        return {"results": [
            {"score": h.score, "payload": h.payload} for h in hits]}

    # ----------------------------------------------------------- query/ask

    @router.route("POST", "/api/v1/query/ask")
    async def ask(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        sp = state.space(body.get("user_id", "default"))
        orch = SearchOrchestrator(
            sp.collection, sp.kg, state.embedder, state.llm,
            llm_tuned_params=bool(body.get("llm_tuned_params")))
        return await orch.ask(body["question"], limit=body.get("limit", 5))

    @router.route("POST", "/v1/embeddings")
    async def embeddings(req: Request):
        """OpenAI-compatible embeddings endpoint (parity: ModelRouterAPI
        embeddings.py:38-56 — message-style image inputs route to the
        multimodal encoder when one is configured)."""
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        raw = body.get("input", [])
        if isinstance(raw, str):
            raw = [raw]
        texts = []
        images = []  # per input row: (size,size,3) raster or None

        def _data_url_bytes(url):
            import base64

            if not (isinstance(url, str) and url.startswith("data:")):
                return None
            try:
                return base64.b64decode(url.split(",", 1)[1])
            except (IndexError, ValueError):
                return None

        for item in raw:
            if isinstance(item, str):
                texts.append(item)
                images.append(None)
            elif isinstance(item, list):  # message-style content blocks
                texts.append(" ".join(
                    b.get("text", "") for b in item
                    if isinstance(b, dict) and b.get("type") == "text"))
                img = None
                for b in item:
                    if not (isinstance(b, dict)
                            and b.get("type") in ("image_url", "input_image")
                            and state.embedder.supports_images):
                        continue
                    u = b.get("image_url")
                    u = u.get("url") if isinstance(u, dict) else u
                    data = _data_url_bytes(u)
                    if data is None:
                        continue
                    from ..models.image import ImageError, image_to_input

                    try:  # PNG/JPEG rasters fuse with the text tokens;
                        # other formats fall back to text-only
                        img = image_to_input(
                            data, state.embedder.state.model.image_size)
                        break
                    except ImageError:
                        continue
                images.append(img)
            else:
                texts.append(str(item))
                images.append(None)
        import asyncio as _asyncio

        def _encode():
            import numpy as _np

            out = _np.zeros((len(texts), state.embedder.dim), _np.float32)
            t_rows = [i for i, im in enumerate(images) if im is None]
            i_rows = [i for i, im in enumerate(images) if im is not None]
            if t_rows:
                out[t_rows] = state.embedder.encode(
                    [texts[i] for i in t_rows])
            if i_rows:  # single-tower fusion: patches + caption tokens
                out[i_rows] = state.embedder.encode_image(
                    _np.stack([images[i] for i in i_rows]),
                    texts=[texts[i] for i in i_rows])
            return out

        vecs = await _asyncio.get_running_loop().run_in_executor(
            None, _encode)
        return {
            "object": "list",
            "model": body.get("model", "rag-tpu-encoder"),
            "data": [{"object": "embedding", "index": i,
                      "embedding": v.tolist()} for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": sum(len(t.split()) for t in texts),
                      "total_tokens": sum(len(t.split()) for t in texts)},
        }

    # ------------------------------------------------------ chat (OpenAI)

    def _make_agent(user_id: str, agent_name: str = "chat") -> BaseAgent:
        import inspect

        sp = state.space(user_id)
        tools = KnowledgeSearchToolbox(sp.collection, sp.kg,
                                       state.embedder).build()
        common = dict(checkpointer=state.checkpointer,
                      memory_store=state.memory, user_id=user_id)
        if agent_name in ("chat", "", None):
            agent = BaseAgent(state.llm, system_prompt=RAG_SYSTEM_PROMPT,
                              **common)
            agent.bind_tools([tools.get(n) for n in tools.names()])
            return agent
        from ..agents import get_agent_by_id

        cls = get_agent_by_id(agent_name)
        if cls is None:
            raise KeyError(agent_name)
        # registry agents take the knowledge toolbox under different
        # keyword names (ChatAgent: knowledge_toolbox; others: toolbox) —
        # and some (WaiterAgent) bind their own domain tools instead
        params = inspect.signature(cls.__init__).parameters
        kw = dict(common)
        if "knowledge_toolbox" in params:
            kw["knowledge_toolbox"] = tools
        elif "toolbox" in params:
            kw["toolbox"] = tools
        return cls(state.llm, **kw)

    @router.route("POST", "/chat/completions")
    async def chat_completions(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        user_id = body.get("user", "default")
        # a request without thread_id is a stateless OpenAI-style call:
        # give it a fresh thread instead of one shared per-user thread
        # (context bled between unrelated conversations otherwise); pass
        # thread_id back from the response to continue a conversation
        thread_id = body.get("thread_id") or f"chat-{uuid.uuid4().hex[:12]}"
        messages = body.get("messages", [])
        user_msg = next((m["content"] for m in reversed(messages)
                         if m.get("role") == "user"), "")
        agent = _make_agent(user_id)
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        model = body.get("model", state.llm.model)

        if body.get("stream"):
            async def events():
                async for ev in agent.astream(user_msg, thread_id=thread_id):
                    if ev["type"] == "message":
                        yield {
                            "id": completion_id,
                            "object": "chat.completion.chunk",
                            "created": int(time.time()),
                            "model": model,
                            "choices": [{"index": 0,
                                         "delta": {"content": ev["delta"]},
                                         "finish_reason": None}],
                        }
                    elif ev["type"] == "tool":
                        yield {
                            "id": completion_id,
                            "object": "chat.completion.chunk",
                            "created": int(time.time()),
                            "model": model,
                            "choices": [{"index": 0, "delta": {},
                                         "finish_reason": None}],
                            "tool_status": ev,
                        }
                yield {
                    "id": completion_id,
                    "object": "chat.completion.chunk",
                    "created": int(time.time()),
                    "model": model,
                    "choices": [{"index": 0, "delta": {},
                                 "finish_reason": "stop"}],
                }
            return SSEResponse(events())

        out = await agent.ainvoke(user_msg, thread_id=thread_id)
        usage = out["token_usage_history"][-1] if out["token_usage_history"] else {}
        return {
            "id": completion_id,
            "object": "chat.completion",
            "created": int(time.time()),
            "model": model,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out["content"]},
                "finish_reason": "stop",
            }],
            "usage": usage,
            "thread_id": thread_id,
            "checkpoint_id": out["checkpoint_id"],
        }

    # -------- server-side thread history for the L7 chat page (the
    # reference's AgentChatUI persists threads via the LangGraph SDK;
    # here the ThreadCheckpointer that already backs agent resume is
    # exposed so /chat reloads conversations across page loads) --------

    @router.route("GET", "/chat/threads")
    async def chat_threads(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        return {"threads": state.checkpointer.list_threads()}

    @router.route("GET", "/chat/threads/{thread_id}")
    async def chat_thread_messages(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        tid = req.params["thread_id"]
        msgs = [m for m in state.checkpointer.thread_messages(tid)
                if m.get("role") in ("user", "assistant")
                and m.get("content")]
        return {"thread_id": tid, "messages": msgs}

    @router.route("DELETE", "/chat/threads/{thread_id}")
    async def chat_thread_delete(req: Request):
        if (deny := _auth(req)) is not None:
            return deny
        state.checkpointer.drop_thread(req.params["thread_id"])
        return {"ok": True}

    @router.route("POST", "/copilotkit")
    async def copilotkit(req: Request):
        """Remote-agent endpoint for UI runtimes (parity in role with the
        CopilotKit route, AgentAPI/app/api/routes/copilotkit.py:1-217: the
        reference wraps its agents in a CopilotKitRemoteEndpoint keyed by
        per-request properties {user_id, org_id, thread_id,
        checkpoint_id}). The SDK's GraphQL transport is vendor-specific;
        this speaks a JSON/SSE protocol-lite with the same two verbs:

          {"method": "info"}              -> available agents
          {"method": "agent/execute",
           "agent": "...", "properties": {...},
           "messages": [...]}             -> SSE event stream
        """
        if (deny := _auth(req)) is not None:
            return deny
        body = req.json()
        method = body.get("method", "info")

        from ..agents import AGENT_CLASS_MAP, get_agent_by_id

        get_agent_by_id("")  # force registry population
        if method == "info":
            return {"agents": [
                {"name": name, "description": cls.__doc__ or ""}
                for name, cls in AGENT_CLASS_MAP.items()
            ] + [{"name": "chat", "description": "knowledge-tool chat agent"}],
                "actions": []}
        if method != "agent/execute":
            return JSONResponse({"detail": f"unknown method {method}"}, 422)

        props = body.get("properties", {})
        user_id = props.get("user_id", "copilotkit-user")
        thread_id = props.get("thread_id") or f"{user_id}-thread"
        messages = body.get("messages", [])
        user_msg = next((m["content"] for m in reversed(messages)
                         if m.get("role") == "user"), "")
        try:
            agent = _make_agent(user_id, body.get("agent", "chat"))
        except KeyError:
            return JSONResponse(
                {"detail": f"unknown agent {body.get('agent')!r}"}, 404)

        async def events():
            async for ev in agent.astream(user_msg, thread_id=thread_id):
                if ev["type"] == "message":
                    yield {"event": "message", "delta": ev["delta"]}
                elif ev["type"] == "tool":
                    yield {"event": "tool", **{k: v for k, v in ev.items()
                                               if k != "type"}}
            yield {"event": "done", "thread_id": thread_id}
        return SSEResponse(events())

    return router, state
