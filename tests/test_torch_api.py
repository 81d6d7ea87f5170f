"""The port's HTTP service (`api/*`, `serve.py`) against the JAX package's,
on the CPU.

The request sequences of tests/test_api.py, tests/test_api_extra.py and
tests/test_admin_api.py go to a JAX app and a port app in lockstep, each
under its own `HTTPServer`, with the STUB router, encoders with the same
weights (`state.encoder_params_from_jax`) and, after every request, the
reference's dense tables carried into the port's user spaces
(`state.dense_from_numpy`; tests/test_torch_prep.py bounds the
insert-time rounding this removes). Ingest runs with one worker in both,
so that a document's chunks take the same rows. Every response must
agree:

- status codes, ids, document ids, texts and counts are equal;
- floats (scores) are within 1e-5;
- what is random or made from the clock is excluded: 12+ digit hex runs
  (uuids, approval, thread, completion and user ids) are masked, and the
  keys in `RANDOM_KEYS` (timestamps, tokens, checkpoint ids) dropped.

Checkpoints cross the packages both ways, through `/admin/checkpoint` +
`/admin/restore` and through `serve.checkpoint_spaces` +
`serve.restore_spaces`, and `python -m rag_application_tpu_torch.serve`
boots from a JAX-written checkpoint directory with `RAGTPU_PLATFORM=cpu`
and answers `/health` and a hybrid search as the JAX app does.
"""

import ast
import asyncio
import base64
import json
import os
import re
import socket
import subprocess
import sys
import time

import httpx
import numpy as np
import pytest

import rag_application_tpu.serve as jserve
import rag_application_tpu_torch.serve as tserve
from rag_application_tpu.api.app import build_app as j_build_app
from rag_application_tpu.api.http import HTTPServer as JHTTPServer
from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import IngestConfig as JIngestConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.llm.router import LLMRouter as JRouter
from rag_application_tpu.llm.router import Provider as JProvider
from rag_application_tpu_torch.api.app import build_app
from rag_application_tpu_torch.api.http import HTTPServer
from rag_application_tpu_torch.config import Config, EncoderConfig
from rag_application_tpu_torch.config import FunnelConfig
from rag_application_tpu_torch.config import IndexConfig, IngestConfig
from rag_application_tpu_torch.config import SparseConfig
from rag_application_tpu_torch.llm.router import LLMRouter, Provider
from torch_carry import carry_collection, carry_kg, embedder_pair
from torch_carry import jax_embedder_from_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ["api/__init__.py", "api/http.py", "api/users.py",
          "api/chat_ui.py"]
ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=32, out_dim=32, dtype="float32")
RANDOM_KEYS = {"created", "checkpoint_id", "access_token", "created_at",
               "updated_at", "last_login"}
_HEX = re.compile(r"[0-9a-f]{12,}")


def small_config(cls, index, sparse, funnel, ingest):
    """tests/test_api.py's config (with tests/test_admin_api.py's KG
    entity dim), in either package, ingesting with one worker: with
    several, a document's chunks take rows in the order the workers
    finish, which differs between runs, and the carried tables must
    line up with the port's rows."""
    cfg = cls()
    cfg.index = index(dim=32, matryoshka_dims=(8, 16), initial_capacity=16)
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    cfg.ingest = ingest(chunk_chars=300, max_concurrency=1)
    cfg.kg.entity_dim = 32
    return cfg


def j_config():
    return small_config(JConfig, JIndexConfig, JSparseConfig,
                        JFunnelConfig, JIngestConfig)


def t_config():
    return small_config(Config, IndexConfig, SparseConfig, FunnelConfig,
                        IngestConfig)


_EMB = {}


def embedders():
    """(JAX Embedder, port Embedder) with the same weights, built once."""
    if not _EMB:
        _EMB["pair"] = embedder_pair(ECFG, seed=0)
    return _EMB["pair"]


def apps(pair=None, **kw):
    """(JAX router, state), (port router, state) on the same weights: the
    text tower's, or ``pair``'s (JAX Embedder, port Embedder)."""
    jemb, temb = pair or embedders()
    j = j_build_app(j_config(), llm=JRouter(JProvider.STUB), embedder=jemb,
                    **kw)
    t = build_app(t_config(), llm=LLMRouter(Provider.STUB), embedder=temb,
                  device="cpu", **kw)
    return j, t


# `/metrics` families the port keeps and the JAX package has no
# counterpart for: dropped from the port's exposition, the rest is held
# equal
PORT_ONLY_METRICS = ("bm25_queries_encoded_total{",)


def shared_metrics(text: str) -> str:
    lines = text.split("\n")[:-1]  # `Metrics.render` ends every line
    return "\n".join(line for line in lines
                     if not line.startswith(PORT_ONLY_METRICS)) + "\n"


def norm(x):
    """A response body with the random and clock-made parts taken out."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in RANDOM_KEYS}
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, str):
        return _HEX.sub("<hex>", x)
    return x


def assert_close(got, want, path="$"):
    """Equal, floats within 1e-5."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(want,
                                                            (int, float)), path
        assert abs(got - want) <= 1e-5, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (
            path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def parsed(r):
    ctype = r.headers.get("content-type", "")
    if ctype.startswith("application/json"):
        return r.json()
    return r.text


class Dual:
    """Sends each request to the JAX server, then to the port's, carries
    the JAX dense tables into the port's spaces, and holds the two
    responses equal. Returns the port's response."""

    def __init__(self, jclient, tclient, jstate, tstate):
        self.jc, self.tc = jclient, tclient
        self.js, self.ts = jstate, tstate
        self.pairs = 0

    def carry(self):
        for uid, jsp in list(self.js.users.items()):
            tsp = self.ts.users.get(uid)
            if tsp is not None:
                carry_collection(jsp.collection, tsp.collection)
                carry_kg(jsp.kg, tsp.kg)

    async def request(self, method, path, **kw):
        rj = await self.jc.request(method, path, **kw)
        rt = await self.tc.request(method, path, **kw)
        self.carry()
        assert rt.status_code == rj.status_code, (path, rt.text, rj.text)
        assert rt.headers.get("content-type") == rj.headers.get(
            "content-type")
        got = parsed(rt)
        if path == "/metrics":
            got = shared_metrics(got)
        assert_close(norm(got), norm(parsed(rj)), path)
        self.pairs += 1
        return rt

    async def get(self, path, **kw):
        return await self.request("GET", path, **kw)

    async def post(self, path, **kw):
        return await self.request("POST", path, **kw)

    async def put(self, path, **kw):
        return await self.request("PUT", path, **kw)

    async def delete(self, path, **kw):
        return await self.request("DELETE", path, **kw)

    async def sse(self, method, path, **kw):
        """The SSE events of each server (parsed data lines up to
        [DONE]); the port's, after holding them equal."""
        async def events(client):
            out = []
            async with client.stream(method, path, **kw) as r:
                assert r.headers["content-type"].startswith(
                    "text/event-stream")
                async for line in r.aiter_lines():
                    if line.startswith("data:"):
                        data = line[5:].strip()
                        if data == "[DONE]":
                            break
                        out.append(json.loads(data))
            return out

        want = await events(self.jc)
        got = await events(self.tc)
        self.carry()
        assert_close(norm(got), norm(want), path)
        self.pairs += 1
        return got


def with_servers(fn, pair=None, **kw):
    """Run ``fn(dual)`` against a JAX and a port server."""
    async def main():
        (jr, js), (tr, ts) = apps(pair, **kw)
        jsrv, tsrv = JHTTPServer(jr, port=0), HTTPServer(tr, port=0)
        jport, tport = await jsrv.start(), await tsrv.start()
        try:
            async with httpx.AsyncClient(
                    base_url=f"http://127.0.0.1:{jport}", timeout=60) as jc, \
                    httpx.AsyncClient(
                        base_url=f"http://127.0.0.1:{tport}",
                        timeout=60) as tc:
                dual = Dual(jc, tc, js, ts)
                await fn(dual)
                assert dual.pairs > 0
        finally:
            await jsrv.stop()
            await tsrv.stop()

    asyncio.run(main())


def body(source):
    """A module's source below its docstring."""
    doc = ast.parse(source).body[0]
    return "\n".join(source.split("\n")[doc.end_lineno:])


@pytest.mark.parametrize("path", COPIED)
def test_copy_is_verbatim(path):
    with open(os.path.join(_REPO, "rag_application_tpu", path)) as f:
        src = f.read()
    with open(os.path.join(_REPO, "rag_application_tpu_torch", path)) as f:
        copy = f.read()
    assert f"Copy of `rag_application_tpu/{path}`" in copy
    doc = ast.parse(src).body[0]
    has_doc = (isinstance(doc, ast.Expr)
               and isinstance(doc.value, ast.Constant))
    assert body(copy) == (body(src) if has_doc else "\n" + src)
    assert not re.search(r"^\s*(from|import) (jax|flax|rag_application_tpu)\b",
                         copy, re.M)


def test_build_app_runs_on_cuda_unless_asked():
    """No path carries on on the CPU when no card is found: the default
    device is cuda, and without one build_app raises."""
    _, temb = embedders()
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_app(t_config(), llm=LLMRouter(Provider.STUB),
                      embedder=temb)
    _, ts = build_app(t_config(), llm=LLMRouter(Provider.STUB),
                      embedder=temb, device="cpu")
    sp = ts.space("u")
    assert sp.collection.device.type == "cpu" and sp.kg.device.type == "cpu"
    assert ts.device.type == "cpu"


# ------------------------------------------------------ tests/test_api.py


def test_health_and_models():
    async def fn(c):
        await c.get("/health")
        r = await c.get("/v1/models")
        assert "stub-model" in [m["id"] for m in r.json()["data"]]
        await c.get("/metrics")
    with_servers(fn)


def test_404_and_405():
    async def fn(c):
        assert (await c.get("/nope")).status_code == 404
        assert (await c.get("/ingest/file")).status_code == 405
    with_servers(fn)


def test_ingest_search_ask_delete_flow():
    async def fn(c):
        text = ("Vivek Malipatel created the OmniRAG retrieval platform. "
                "It uses hybrid dense and sparse search with rank fusion. ") * 5
        r = await c.post("/ingest/raw-text", json={
            "text": text, "document_id": "omnirag-doc", "user_id": "alice"})
        assert r.status_code == 202 and r.json()["chunks"] >= 1
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "who created omnirag", "user_id": "alice", "limit": 3})
        hits = r.json()["results"]
        assert hits and hits[0]["payload"]["document_id"] == "omnirag-doc"
        r = await c.post("/search/scout", json={
            "query": "omnirag platform", "user_id": "alice"})
        assert r.json()["results"]
        r = await c.post("/api/v1/query/ask", json={
            "question": "Who created OmniRAG?", "user_id": "alice"})
        assert r.json()["sources"][0]["document_id"] == "omnirag-doc"
        r = await c.post("/delete/file", json={
            "document_id": "omnirag-doc", "user_id": "alice"})
        assert r.json()["deleted_chunks"] >= 1
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "omnirag", "user_id": "alice"})
        assert r.json()["results"] == []
    with_servers(fn)


def test_ingest_file_b64_csv():
    pytest.importorskip("pandas")

    async def fn(c):
        csv = base64.b64encode(b"name,age\nalice,30\nbob,25\n").decode()
        r = await c.post("/ingest/file", json={
            "filename": "people.csv", "content_b64": csv, "user_id": "bob"})
        assert r.status_code == 202 and r.json()["chunks"] == 1
        r = await c.post("/search/query", json={
            "user_id": "bob", "tool": "get_column_values",
            "args": {"column_name": "name"}})
        assert [v["value"] for v in r.json()["result"]["values"]] == [
            "alice", "bob"]
    with_servers(fn)


def test_structured_query_unknown_tool():
    async def fn(c):
        r = await c.post("/search/query", json={"tool": "drop_tables",
                                                "user_id": "x"})
        assert r.status_code == 422 and "available" in r.json()["detail"]
    with_servers(fn)


def test_chat_completions_non_streaming():
    async def fn(c):
        r = await c.post("/chat/completions", json={
            "model": "stub-model", "user": "carol",
            "messages": [{"role": "user", "content": "hello agent"}]})
        first = r.json()
        assert first["object"] == "chat.completion"
        assert first["choices"][0]["message"]["content"]
        # the second turn continues the same thread in each package
        thread = "chat-carolthread"
        for msg in ("hello agent", "and again"):
            r = await c.post("/chat/completions", json={
                "model": "stub-model", "user": "carol", "thread_id": thread,
                "messages": [{"role": "user", "content": msg}]})
            assert r.json()["thread_id"] == thread
    with_servers(fn)


def test_chat_completions_streaming_sse():
    async def fn(c):
        chunks = await c.sse("POST", "/chat/completions", json={
            "model": "stub-model", "user": "dave", "stream": True,
            "messages": [{"role": "user", "content": "stream please"}]})
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        assert "stream please" in "".join(
            ch["choices"][0]["delta"].get("content", "") for ch in chunks)
    with_servers(fn)


def test_api_key_auth():
    async def fn(c):
        r = await c.post("/search/scout", json={"query": "x"})
        assert r.status_code == 401
        r = await c.post("/search/scout", json={"query": "x"},
                         headers={"Authorization": "Bearer sekret"})
        assert r.status_code == 200
    with_servers(fn, api_key="sekret")


def test_copilotkit_info_and_execute():
    async def fn(c):
        r = await c.post("/copilotkit", json={"method": "info"})
        names = [a["name"] for a in r.json()["agents"]]
        assert "chat" in names and "deep_research_agent" in names
        events = await c.sse("POST", "/copilotkit", json={
            "method": "agent/execute", "agent": "chat",
            "properties": {"user_id": "erin", "thread_id": "t-ck"},
            "messages": [{"role": "user", "content": "hello runtime"}]})
        assert events[-1] == {"event": "done", "thread_id": "t-ck"}
        assert "hello runtime" in "".join(
            e.get("delta", "") for e in events if e["event"] == "message")
        assert (await c.post("/copilotkit", json={"method": "bogus"})
                ).status_code == 422
        r = await c.post("/copilotkit", json={
            "method": "agent/execute", "agent": "no-such-agent",
            "messages": [{"role": "user", "content": "x"}]})
        assert r.status_code == 404
    with_servers(fn)


def test_signin_token_opens_protected_routes():
    async def fn(c):
        for method, path in (("PUT", "/api/v1/users/u1"),
                             ("DELETE", "/api/v1/users/u1"),
                             ("POST", "/api/v1/agents"),
                             ("DELETE", "/api/v1/documents/d1"),
                             ("GET", "/queue/info"),
                             ("POST", "/webhook/storage")):
            r = await c.request(method, path, json={})
            assert r.status_code == 401, (method, path)
        creds = {"username": "ann", "password": "pw12345"}
        assert (await c.post("/api/v1/users/signup", json=creds)
                ).status_code == 401
        r = await c.post("/api/v1/users/signup", json=creds,
                         headers={"authorization": "Bearer sekret"})
        assert r.status_code == 201
        # each package signs its own token: send each its own
        tokens = []
        for client in (c.jc, c.tc):
            r = await client.post("/api/v1/users/signin", json=creds)
            assert r.status_code == 200
            tokens.append(r.json()["access_token"])
        rj = await c.jc.get("/queue/info",
                            headers={"authorization": f"Bearer {tokens[0]}"})
        rt = await c.tc.get("/queue/info",
                            headers={"authorization": f"Bearer {tokens[1]}"})
        assert rt.status_code == rj.status_code == 200
        assert rt.json() == rj.json()
        r = await c.get("/queue/info",
                        headers={"authorization": "Bearer sekret"})
        assert r.status_code == 200
    with_servers(fn, api_key="sekret")


def test_upload_complete_rejects_missing_chunks():
    async def fn(c):
        # approval ids are random: drive each server with its own
        ids = []
        for client in (c.jc, c.tc):
            r = await client.post("/api/v1/upload/start",
                                  json={"filename": "f.txt", "user_id": "u"})
            ids.append(r.json()["approval_id"])

        async def both(path, **kw):
            rj = await c.jc.post(path.format(ids[0]), **kw)
            rt = await c.tc.post(path.format(ids[1]), **kw)
            c.carry()
            assert rt.status_code == rj.status_code
            assert_close(norm(rt.json()), norm(rj.json()))
            return rt

        await both("/api/v1/upload/chunk/{}/0", content=b"part0 ")
        await both("/api/v1/upload/chunk/{}/2", content=b"part2")
        assert (await both("/api/v1/upload/complete/{}")).status_code == 422
        await both("/api/v1/upload/chunk/{}/1", content=b"part1 ")
        assert (await both("/api/v1/upload/complete/{}")).status_code == 202
        await c.get("/api/v1/documents", params={"user_id": "u"})
    with_servers(fn)


def test_stateless_chats_get_distinct_threads():
    async def fn(c):
        r1 = await c.post("/chat/completions", json={
            "model": "stub-model", "user": "u",
            "messages": [{"role": "user", "content": "first"}]})
        r2 = await c.post("/chat/completions", json={
            "model": "stub-model", "user": "u",
            "messages": [{"role": "user", "content": "second"}]})
        assert r1.json()["thread_id"] != r2.json()["thread_id"]
    with_servers(fn)


def test_chat_page_round_trip():
    async def fn(c):
        r = await c.get("/chat")
        assert r.headers["content-type"].startswith("text/html")
        for needle in ("/v1/chat/completions", "/chat/completions",
                       "/v1/models", "getReader"):
            assert needle in r.text, needle
        chunks = await c.sse("POST", "/v1/chat/completions", json={
            "model": "stub-model", "stream": True,
            "messages": [{"role": "user", "content": "hello page"}]})
        assert "hello page" in "".join(
            ch["choices"][0]["delta"].get("content", "") for ch in chunks)
    with_servers(fn)


def test_chat_threads_server_side():
    async def fn(c):
        r = await c.post("/chat/completions", json={
            "model": "stub-model", "thread_id": "chat-testthread01",
            "messages": [{"role": "user", "content": "remember me"}]})
        assert r.json()["thread_id"] == "chat-testthread01"
        r = await c.get("/chat/threads")
        mine = [t for t in r.json()["threads"]
                if t["thread_id"] == "chat-testthread01"]
        assert mine and "remember me" in mine[0]["title"]
        r = await c.get("/chat/threads/chat-testthread01")
        msgs = r.json()["messages"]
        assert msgs[0] == {"role": "user", "content": "remember me"}
        assert any(m["role"] == "assistant" for m in msgs)
        assert (await c.delete("/chat/threads/chat-testthread01")
                ).json()["ok"]
        r = await c.get("/chat/threads")
        assert not any(t["thread_id"] == "chat-testthread01"
                       for t in r.json()["threads"])
    with_servers(fn)


# ------------------------------------------------ tests/test_api_extra.py


def test_chunked_upload_protocol():
    async def fn(c):
        ids = []
        for client in (c.jc, c.tc):
            r = await client.post("/api/v1/upload/start", json={
                "filename": "big.txt", "user_id": "u"})
            ids.append(r.json()["approval_id"])
        data = ("chunk one of the file. " * 20).encode()
        half = len(data) // 2
        for path, kw, status in (
                ("/api/v1/upload/chunk/{}/1", {"content": data[half:]}, 200),
                ("/api/v1/upload/chunk/{}/0", {"content": data[:half]}, 200),
                ("/api/v1/upload/complete/{}", {}, 202),
                ("/api/v1/upload/complete/{}", {}, 404)):
            rj = await c.jc.post(path.format(ids[0]), **kw)
            rt = await c.tc.post(path.format(ids[1]), **kw)
            c.carry()
            assert rt.status_code == rj.status_code == status
            assert_close(norm(rt.json()), norm(rj.json()))
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "chunk of the file", "user_id": "u"})
        assert r.json()["results"]
    with_servers(fn)


def test_storage_webhook():
    async def fn(c):
        r = await c.post("/webhook/storage", json={"Records": [
            {"s3": {"object": {"key": "hooked.txt"}},
             "user_id": "w", "content": "webhook ingested text " * 10}]})
        assert r.status_code == 202 and r.json()["accepted"] == [
            "hooked.txt"]
        r = await c.get("/api/v1/documents", params={"user_id": "w"})
        assert r.json()["documents"][0]["document_id"] == "hooked.txt"
    with_servers(fn)


def test_agents_catalog():
    async def fn(c):
        r = await c.get("/agents")
        assert {"chat_agent", "deep_research_agent",
                "knowledge_search_agent"} <= {a["id"] for a in
                                              r.json()["agents"]}
    with_servers(fn)


def test_llm_passthrough_non_stream_and_stream():
    async def fn(c):
        r = await c.post("/v1/chat/completions", json={
            "messages": [{"role": "user", "content": "passthrough hello"}]})
        assert r.json()["choices"][0]["message"]["content"].startswith(
            "[stub]")
        schema = {"type": "object", "properties": {
            "kind": {"enum": ["alpha", "beta"]}, "ok": {"type": "boolean"}}}
        r = await c.post("/v1/chat/completions", json={
            "messages": [{"role": "user", "content": "structured"}],
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": schema}}})
        assert set(json.loads(r.json()["choices"][0]["message"]["content"])
                   ) == {"kind", "ok"}
        chunks = await c.sse("POST", "/v1/chat/completions", json={
            "stream": True,
            "messages": [{"role": "user", "content": "stream pass"}]})
        assert "stream pass" in "".join(
            ch["choices"][0]["delta"].get("content", "") for ch in chunks)
    with_servers(fn)


def test_user_signup_signin_crud():
    async def fn(c):
        r = await c.post("/api/v1/users/signup", json={
            "username": "vivek", "password": "s3cret", "email": "v@x.io"})
        assert r.status_code == 201
        # user ids are random: each package's own
        uids = [c.js.user_registry.list()[0]["user_id"],
                c.ts.user_registry.list()[0]["user_id"]]
        assert uids[1] == r.json()["user_id"]
        assert (await c.post("/api/v1/users/signup", json={
            "username": "vivek", "password": "other"})).status_code == 422
        r = await c.post("/api/v1/users/signin", json={
            "username": "vivek", "password": "wrong"})
        assert r.status_code == 401
        for method, kw, want in (("GET", {}, 200),
                                 ("PUT", {"json": {"email": "new@x.io"}}, 200),
                                 ("DELETE", {}, 200), ("GET", {}, 404)):
            rj = await c.jc.request(method, f"/api/v1/users/{uids[0]}", **kw)
            rt = await c.tc.request(method, f"/api/v1/users/{uids[1]}", **kw)
            assert rt.status_code == rj.status_code == want
            assert_close(norm(rt.json()), norm(rj.json()))
        await c.get("/api/v1/users")
    with_servers(fn)


def test_agent_config_crud_and_tools_listing():
    async def fn(c):
        r = await c.post("/api/v1/agents", json={
            "name": "support bot", "base": "chat_agent",
            "system_prompt": "be nice"})
        assert r.status_code == 201
        aids = [c.js.agent_registry.list()[0]["agent_id"],
                c.ts.agent_registry.list()[0]["agent_id"]]
        assert (await c.post("/api/v1/agents", json={
            "name": "x", "base": "nope"})).status_code == 422
        await c.get("/api/v1/agents")
        for method, kw in (("PUT", {"json": {"name": "bot2"}}),
                           ("DELETE", {})):
            rj = await c.jc.request(method, f"/api/v1/agents/{aids[0]}", **kw)
            rt = await c.tc.request(method, f"/api/v1/agents/{aids[1]}", **kw)
            assert rt.status_code == rj.status_code == 200
            assert_close(norm(rt.json()), norm(rj.json()))
        r = await c.get("/v1/tools")
        assert len(r.json()["tools"]) >= 21
    with_servers(fn)


def test_documents_rest_crud():
    async def fn(c):
        await c.post("/ingest/raw-text", json={
            "text": "document body text " * 20, "document_id": "docA",
            "user_id": "d"})
        r = await c.get("/api/v1/documents/docA", params={"user_id": "d"})
        assert r.status_code == 200 and r.json()["chunks"] >= 1
        assert (await c.get("/api/v1/documents/missing",
                            params={"user_id": "d"})).status_code == 404
        r = await c.delete("/api/v1/documents/docA", params={"user_id": "d"})
        assert r.json()["deleted_chunks"] >= 1
        assert (await c.delete("/api/v1/documents/docA",
                               params={"user_id": "d"})).status_code == 404
    with_servers(fn)


async def _raw_exchange(server_cls, router, payloads):
    """Bytes a server sends back on one connection for each payload."""
    server = server_cls(router, port=0)
    port = await server.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for data in payloads:
            writer.write(data)
            await writer.drain()
            out.append(await asyncio.wait_for(reader.read(4096), 10))
        writer.close()
        await writer.wait_closed()
        return out
    finally:
        await server.stop()


def _ping_router(mod):
    router = mod.Router()

    @router.route("GET", "/ping")
    async def ping(req):
        return mod.JSONResponse({"ok": True})

    return router


@pytest.mark.parametrize("payloads", [
    [b"GET /ping HTTP/1.1\r\nhost: x\r\n\r\n"] * 3 + [
        b"GET /ping HTTP/1.1\r\nhost: x\r\nconnection: close\r\n\r\n"],
    [b"GET /ping HTTP/1.1\r\nhost: x\r\ntransfer-encoding: chunked\r\n\r\n"
     b"5\r\nhello\r\n0\r\n\r\n"],
], ids=["keep_alive_reuses_connection", "chunked_request_closes_connection"])
def test_raw_connection_bytes_equal(payloads):
    """tests/test_api_extra.py's keep-alive and chunked-body cases: the
    same bytes back from both servers on one connection."""
    import rag_application_tpu.api.http as jh
    import rag_application_tpu_torch.api.http as th

    want = asyncio.run(_raw_exchange(jh.HTTPServer, _ping_router(jh),
                                     payloads))
    got = asyncio.run(_raw_exchange(th.HTTPServer, _ping_router(th),
                                    payloads))
    assert got == want
    assert all(b"200" in r for r in got)
    assert b"connection: close" in got[-1]


def test_app_wires_kg_extractor_into_ingest():
    async def extractor(text):
        return {"entities": [
            {"id": "ada", "text": "Ada", "entity_type": "PERSON",
             "entity_profile": "mathematician"}], "relationships": []}

    (_, js), (_, ts) = apps(kg_extractor=extractor)
    out = []
    for st in (js, ts):
        sp = st.space("u1")
        assert sp.pipeline.kg_extractor is extractor
        res = asyncio.run(sp.pipeline.ingest_text(
            "Ada wrote the first program.", document_id="d1"))
        out.append((res.failed_tasks, res.chunks, sp.kg.stats(),
                    sorted(e.get("text") for e in sp.kg.get_entities())))
    assert out[1] == out[0] and "Ada" in out[1][3]


def test_filtered_search_and_collection_counts():
    async def fn(c):
        for did, text in [
            ("doc-cats", "Cats are small carnivorous mammals kept as pets. "
             * 4),
            ("doc-dogs", "Dogs are loyal domesticated canines kept as pets. "
             * 4)]:
            await c.post("/ingest/raw-text", json={
                "text": text, "document_id": did, "user_id": "filt"})
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "pets kept at home", "user_id": "filt", "limit": 8})
        assert {h["payload"]["document_id"] for h in r.json()["results"]} \
            == {"doc-cats", "doc-dogs"}
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "loyal dogs", "user_id": "filt", "limit": 8,
            "filters": {"document_id": "doc-cats"}})
        assert {h["payload"]["document_id"] for h in r.json()["results"]} \
            == {"doc-cats"}
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "pets", "user_id": "filt",
            "filters": {"document_id": "no-such-doc"}})
        assert r.json()["results"] == []
        await c.get("/api/v1/collections")
        await c.get("/api/v1/collections/filt/count")
        r = await c.get("/api/v1/collections/filt/count?document_id=doc-cats")
        assert r.json()["chunks"] > 0
        await c.get("/api/v1/collections/nobody/count")
        await c.post("/v1/embeddings", json={
            "input": ["pets", [{"type": "text", "text": "dogs"}], 3]})
    with_servers(fn)


_MM = {}


def mm_embedders():
    """(JAX Embedder, port Embedder) on the multimodal tower, built once."""
    if not _MM:
        _MM["pair"] = embedder_pair(ECFG, seed=3, multimodal=True)
    return _MM["pair"]


def data_url(mime, data):
    return f"data:{mime};base64," + base64.b64encode(data).decode()


@pytest.mark.parametrize("tower", ["multimodal", "text"])
def test_embeddings_image_blocks(tower):
    """tests/test_image.py's and tests/test_jpeg.py's /v1/embeddings image
    blocks (PNG and JPEG data URLs fused with their captions, an image
    alone, a GIF and a broken data URL falling back to text-only, the
    ``input_image`` type), in lockstep; a text tower drops the images in
    both. The port's vectors equal its own `encode_image` calls."""
    from rag_application_tpu_torch.ingest.pdf import _make_png
    from rag_application_tpu_torch.models.image import image_to_input
    from rag_application_tpu_torch.models.jpeg import encode_jpeg

    rng = np.random.default_rng(0)
    png = _make_png(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8
                                 ).tobytes(), 32, 32, 8, "rgb")
    yy, xx = np.mgrid[0:40, 0:40]
    jpeg = encode_jpeg(np.stack([np.sin(xx / 7.0) * 0.5 + 0.5,
                                 np.cos(yy / 5.0) * 0.5 + 0.5,
                                 (xx + yy) / 80.0], -1), quality=92)
    pair = mm_embedders() if tower == "multimodal" else embedders()

    async def fn(c):
        r = await c.post("/v1/embeddings", json={"input": [
            "plain text row",
            [{"type": "text", "text": "a photo"},
             {"type": "image_url",
              "image_url": {"url": data_url("image/png", png)}}],
            [{"type": "text", "text": "a photo"},
             {"type": "image_url", "image_url": data_url("image/jpeg", jpeg)}],
            [{"type": "input_image", "image_url": data_url("image/png", png)}],
            [{"type": "text", "text": "a gif"},
             {"type": "image_url", "image_url": data_url(
                 "image/gif", b"GIF89a" + bytes(32))}],
            [{"type": "text", "text": "broken"},
             {"type": "image_url", "image_url": "data:image/png;base64"}],
            [{"type": "text", "text": "a photo"}],
        ]})
        data = [np.asarray(d["embedding"], np.float32)
                for d in r.json()["data"]]
        temb = pair[1]
        if tower == "multimodal":
            size = temb.state.model.image_size
            want = temb.encode_image(
                np.stack([image_to_input(png, size),
                          image_to_input(jpeg, size),
                          image_to_input(png, size)]),
                texts=["a photo", "a photo", ""])
            np.testing.assert_allclose(np.stack(data[1:4]), want, atol=1e-6)
            assert float(data[1] @ data[6]) < 0.999  # pixels fused in
        else:
            np.testing.assert_allclose(data[1], data[6], atol=1e-6)
        texts = temb.encode(["plain text row", "a gif", "broken", "a photo"])
        np.testing.assert_allclose(np.stack([data[0], data[4], data[5],
                                             data[6]]), texts, atol=1e-6)
    with_servers(fn, pair)


# ------------------------------------------------ tests/test_admin_api.py


def test_checkpoint_restore_roundtrip(tmp_path):
    async def fn(c):
        await c.post("/ingest/raw-text", json={
            "text": "durable state over restarts " * 10,
            "document_id": "dur", "user_id": "u"})
        paths = [str(tmp_path / "j"), str(tmp_path / "t")]
        for client, path in zip((c.jc, c.tc), paths):
            r = await client.post("/admin/checkpoint",
                                  json={"user_id": "u", "path": path})
            assert r.status_code == 200 and r.json()["chunks"] >= 1
        c.js.users.pop("u")
        c.ts.users.pop("u")
        # each restores the other's snapshot
        for client, path in zip((c.jc, c.tc), paths[::-1]):
            r = await client.post("/admin/restore",
                                  json={"user_id": "u", "path": path})
            assert r.status_code == 200
        assert c.ts.users["u"].collection.device.type == "cpu"
        c.carry()
        r = await c.post("/api/v1/search/hybrid", json={
            "query": "durable state", "user_id": "u"})
        assert r.json()["results"][0]["payload"]["document_id"] == "dur"
    with_servers(fn)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_admin_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """/admin/checkpoint on one package, /admin/restore on the other: the
    restored space answers a hybrid search as the writer's does (the
    restored tables are the writer's, so nothing is carried)."""
    async def fn(c):
        for i, text in enumerate(("durable state over restarts " * 10,
                                  "a second document about graphs " * 8)):
            await c.post("/ingest/raw-text", json={
                "text": text, "document_id": f"doc{i}", "user_id": "u"})
        src, dst = (c.jc, c.tc) if writer == "jax" else (c.tc, c.jc)
        path = str(tmp_path / "snap")
        r = await src.post("/admin/checkpoint",
                           json={"user_id": "u", "path": path})
        saved = r.json()
        r = await dst.post("/admin/restore",
                           json={"user_id": "v", "path": path})
        assert r.status_code == 200
        assert r.json()["chunks"] == saved["chunks"]
        assert r.json()["kg"] == saved["kg"]
        q = {"query": "durable state graphs", "limit": 4}
        rs = await src.post("/api/v1/search/hybrid", json={**q,
                                                          "user_id": "u"})
        rd = await dst.post("/api/v1/search/hybrid", json={**q,
                                                          "user_id": "v"})
        assert rd.json()["results"]
        assert_close(rd.json(), rs.json())
        rs = await src.post("/search/scout", json={**q, "user_id": "u"})
        rd = await dst.post("/search/scout", json={**q, "user_id": "v"})
        assert_close(rd.json(), rs.json())
    with_servers(fn)


def _spaces(state):
    return {u: (sp.collection.chunk_count(), sp.kg.stats())
            for u, sp in state.users.items()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_serve_checkpoint_spaces_cross_packages(tmp_path, writer):
    """`serve.checkpoint_spaces` in one package, `serve.restore_spaces` in
    the other: the same users (accounts too), chunk counts, KG stats and
    fingerprints; the restored spaces search as the writer's."""
    (_, js), (_, ts) = apps()

    async def fill(st):
        for uid, text in (("u1", "alpha beta gamma " * 20),
                          ("u/2", "delta epsilon " * 30)):
            await st.space(uid).pipeline.ingest_text(text,
                                                     document_id="d1")
        st.user_registry.signup("ann", "pw12345")
        st.agent_registry.create("helper", system_prompt="hi")

    src, src_mod, dst_mod = ((js, jserve, tserve) if writer == "jax"
                             else (ts, tserve, jserve))
    asyncio.run(fill(src))
    token = src.user_registry.signin("ann", "pw12345")
    ckpt = str(tmp_path / "auto")
    saved_fp = {}
    assert sorted(src_mod.checkpoint_spaces(src, ckpt, saved_fp)) == [
        "u/2", "u1"]
    assert src_mod.checkpoint_spaces(src, ckpt, saved_fp) == []
    (_, js2), (_, ts2) = apps()
    dst = ts2 if writer == "jax" else js2
    assert sorted(dst_mod.restore_spaces(dst, ckpt)) == ["u/2", "u1"]
    assert _spaces(dst) == _spaces(src)
    for uid in ("u1", "u/2"):
        assert dst_mod.space_fingerprint(dst.users[uid]) == \
            src_mod.space_fingerprint(src.users[uid])
    assert dst.user_registry.verify_token(token) is not None
    assert any(a["name"] == "helper" for a in dst.agent_registry.list())
    if writer == "jax":
        assert ts2.users["u1"].collection.device.type == "cpu"
    jemb, _ = embedders()
    qv = np.asarray(jemb.encode(["alpha beta"]))[0]
    want = src.users["u1"].collection.hybrid_search(qv, "alpha beta",
                                                    limit=3)
    got = dst.users["u1"].collection.hybrid_search(qv, "alpha beta",
                                                   limit=3)
    assert [h.payload for h in got] == [h.payload for h in want]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], rtol=1e-5)


def test_user_registry_survives_restart(tmp_path):
    (_, js), (_, ts) = apps()
    for st, mod in ((js, jserve), (ts, tserve)):
        st.user_registry.signup("ann", "pw12345")
        token = st.user_registry.signin("ann", "pw12345")
        st.agent_registry.create("helper", system_prompt="hi")
        ckpt = str(tmp_path / mod.__name__)
        mod.checkpoint_spaces(st, ckpt, {})
        (_, j2), (_, t2) = apps()
        st2 = j2 if mod is jserve else t2
        mod.restore_spaces(st2, ckpt)
        uid = st2.user_registry.verify_token(token)
        assert uid is not None
        assert any(a["name"] == "helper"
                   for a in st2.agent_registry.list())
        st2.user_registry.update(uid, is_active=False)
        assert st2.user_registry.verify_token(token) is None


def test_restore_skips_unrecoverable_user_id(tmp_path):
    from rag_application_tpu_torch.index.checkpoint import save_collection
    from rag_application_tpu_torch.kg.checkpoint import save_kg
    from rag_application_tpu_torch.kg.store import KGStore
    from rag_application_tpu_torch.store.collection import Collection

    cfg = t_config()
    path = str(tmp_path / "digestdir")
    os.makedirs(path)
    save_collection(Collection("orphan", cfg, device="cpu"),
                    os.path.join(path, "collection"))
    save_kg(KGStore(cfg.kg, device="cpu"), os.path.join(path, "kg"))
    (_, js), (_, ts) = apps()
    assert jserve.restore_spaces(js, str(tmp_path)) == []
    assert tserve.restore_spaces(ts, str(tmp_path)) == []
    assert ts.users == {} and js.users == {}


def test_fingerprint_catches_count_neutral_mutation(tmp_path):
    async def run(st, mod):
        sp = st.space("u")
        await sp.pipeline.ingest_text("alpha " * 40, document_id="A")
        ckpt = str(tmp_path / mod.__name__)
        saved_fp = {}
        first = mod.checkpoint_spaces(st, ckpt, saved_fp)
        n_before = sp.collection.chunk_count()
        sp.collection.delete_document("A")
        await sp.pipeline.ingest_text("omega " * 40, document_id="B")
        second = mod.checkpoint_spaces(st, ckpt, saved_fp)
        return (first, second, n_before, sp.collection.chunk_count(),
                mod.space_fingerprint(sp))

    (_, js), (_, ts) = apps()
    want = asyncio.run(run(js, jserve))
    got = asyncio.run(run(ts, tserve))
    assert got == want and got[:2] == (["u"], ["u"]) and got[2] == got[3]


def test_build_ann_and_search_endpoint():
    async def fn(c):
        for i in range(6):
            await c.post("/ingest/raw-text", json={
                "user_id": "u", "document_id": f"d{i}",
                "text": f"document {i} about topic{i} retrieval engines"})
        assert (await c.post("/api/v1/search/ann", json={
            "user_id": "u", "query": "topic3"})).status_code == 400
        assert (await c.post("/admin/build-ann", json={
            "user_id": "u", "engine": "graph"})).status_code == 400
        r = await c.post("/admin/build-ann", json={
            "user_id": "u", "n_clusters": 4, "bucket_rows": 8, "iters": 3})
        assert r.json()["engine"] == "ivf" and r.json()["rows"] >= 6
        r = await c.post("/api/v1/search/ann", json={
            "user_id": "u", "query": "document 3 about topic3 retrieval "
            "engines", "limit": 3, "ef": 4})
        assert any("topic3" in h["payload"].get("text", "")
                   for h in r.json()["results"])
    with_servers(fn)


# ------------------------------------------------------------- the server


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_main_boots_from_a_jax_checkpoint(tmp_path):
    """`python -m rag_application_tpu_torch.serve` with RAGTPU_PLATFORM=cpu
    restores every user of a JAX-written checkpoint directory and answers
    /health and a hybrid search as the JAX app does. The subprocess's
    default encoder (the tiny widths through RAGTPU_ENCODER_*, the port's
    seed-0 weights, 128-token inputs) is rebuilt here, and its weights
    carried into the JAX app's encoder."""
    from rag_application_tpu_torch.models.embedder import Embedder

    ecfg = dict(ECFG, max_len=128)
    temb = Embedder(cfg=EncoderConfig(**ecfg), device="cpu")
    jemb = jax_embedder_from_port(temb, ecfg, max_len=128)
    js = j_build_app(j_config(), llm=JRouter(JProvider.STUB),
                     embedder=jemb)[1]
    for uid, text in (("alice", "durable state over restarts " * 10),
                      ("bob", "graphs of entities and relations " * 8)):
        asyncio.run(js.space(uid).pipeline.ingest_text(text,
                                                       document_id="d1"))
    ckpt = str(tmp_path / "ckpt")
    assert sorted(jserve.checkpoint_spaces(js, ckpt, {})) == ["alice", "bob"]

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO, RAGTPU_PLATFORM="cpu",
               RAGTPU_PORT=str(port), RAGTPU_HOST="127.0.0.1",
               RAGTPU_CHECKPOINT_DIR=ckpt, RAGTPU_LLM_PROVIDER="stub",
               RAGTPU_INDEX_DIM="32", RAGTPU_INDEX_MATRYOSHKA_DIMS="8,16",
               RAGTPU_INDEX_INITIAL_CAPACITY="16",
               RAGTPU_SPARSE_CANDIDATE_POOL="64",
               RAGTPU_SPARSE_MAX_QUERY_TERMS="8",
               RAGTPU_FUNNEL_MATRYOSHKA_LIMITS="8,6",
               RAGTPU_FUNNEL_DENSE_LIMIT="5",
               RAGTPU_FUNNEL_QUANTIZED_LIMIT="5",
               RAGTPU_FUNNEL_SPARSE_LIMIT="5", RAGTPU_FUNNEL_FINAL_LIMIT="5",
               RAGTPU_INGEST_CHUNK_CHARS="300",
               RAGTPU_INGEST_MAX_CONCURRENCY="1", RAGTPU_KG_ENTITY_DIM="32",
               **{f"RAGTPU_ENCODER_{k.upper()}": str(v)
                  for k, v in ecfg.items()})
    proc = subprocess.Popen([sys.executable, "-m",
                             "rag_application_tpu_torch.serve"],
                            cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                health = httpx.get(url + "/health", timeout=5)
                break
            except httpx.TransportError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.25)
        assert health.json() == {"status": "ok", "users": 2}
        q = {"query": "durable state", "user_id": "alice", "limit": 3}
        got = httpx.post(url + "/api/v1/search/hybrid", json=q,
                         timeout=60).json()

        # the JAX app over the same checkpoint, embedding with the
        # server's encoder weights
        jr, js2 = j_build_app(j_config(), llm=JRouter(JProvider.STUB),
                              embedder=jemb)
        assert sorted(jserve.restore_spaces(js2, ckpt)) == ["alice", "bob"]

        async def ask():
            srv = JHTTPServer(jr, port=0)
            p = await srv.start()
            try:
                async with httpx.AsyncClient(
                        base_url=f"http://127.0.0.1:{p}", timeout=60) as c:
                    return (await c.post("/api/v1/search/hybrid",
                                         json=q)).json()
            finally:
                await srv.stop()

        ref = asyncio.run(ask())
        assert "results" in got, got
        assert got["results"] and got["results"][0]["payload"][
            "document_id"] == "d1"
        assert_close(got, ref)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_serve_main_needs_a_card_unless_asked(monkeypatch):
    """Without RAGTPU_PLATFORM the port's server asks for cuda and, with
    no card, raises before it serves."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("RAGTPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main()


def test_embedder_window_past_the_position_table():
    """An `Embedder` whose window (128 tokens by default) is longer than
    its encoder's position table (`max_len` 32 here) is a fault of the
    caller: the reference's gather fills the missing positions with NaN
    and serves NaN vectors, the port raises. The API tests build their
    embedders with a 16-token window, and the server process test gives
    its encoder a 128-row table."""
    from rag_application_tpu.config import EncoderConfig as JEncoderConfig
    from rag_application_tpu.models.embedder import Embedder as JEmbedder
    from rag_application_tpu_torch.models.embedder import Embedder

    assert np.isnan(JEmbedder(cfg=JEncoderConfig(**ECFG)).encode(
        ["short"])).all()
    with pytest.raises(RuntimeError, match="size of tensor"):
        Embedder(cfg=EncoderConfig(**ECFG), device="cpu").encode(["short"])
