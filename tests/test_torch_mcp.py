"""The port's MCP servers (`mcp/*`) and client (`tools/mcp_client.py`)
against the JAX package's, on the CPU.

`mcp/server.py`, `mcp/file_server.py`, `mcp/search_server.py`,
`mcp/__init__.py` and `tools/mcp_client.py` are the reference's files
verbatim below a header naming the source. The cases of tests/test_mcp.py
and the MCP cases of tests/test_web_tools.py run on both packages: the
permissions, tool lists, JSON-RPC replies and the client's results must
be equal. The search server's hybrid hits agree on text and rows, scores
within 1e-5, over collections whose encoders share weights
(`state.encoder_params_from_jax`) and whose dense tables are the
reference's carried over with `state.dense_from_numpy`.
"""

import ast
import asyncio
import io
import json
import os
import re
import types

import httpx
import pytest

import rag_application_tpu.api.http as j_http
import rag_application_tpu.mcp.file_server as j_file
import rag_application_tpu.mcp.search_server as j_search
import rag_application_tpu.mcp.server as j_server
import rag_application_tpu.tools.mcp_client as j_client
import rag_application_tpu.tools.registry as j_registry
import rag_application_tpu_torch.api.http as t_http
import rag_application_tpu_torch.mcp.file_server as t_file
import rag_application_tpu_torch.mcp.search_server as t_search
import rag_application_tpu_torch.mcp.server as t_server
import rag_application_tpu_torch.tools.mcp_client as t_client
import rag_application_tpu_torch.tools.registry as t_registry
from rag_application_tpu.config import Config as JConfig
from rag_application_tpu.config import FunnelConfig as JFunnelConfig
from rag_application_tpu.config import IndexConfig as JIndexConfig
from rag_application_tpu.config import KGConfig as JKGConfig
from rag_application_tpu.config import SparseConfig as JSparseConfig
from rag_application_tpu.kg.store import KGStore as JKGStore
from rag_application_tpu.store.collection import Collection as JCollection
from rag_application_tpu_torch.config import Config
from rag_application_tpu_torch.config import FunnelConfig, IndexConfig
from rag_application_tpu_torch.config import KGConfig, SparseConfig
from rag_application_tpu_torch.kg.store import KGStore
from rag_application_tpu_torch.store.collection import Collection
from torch_carry import carry_collection, embedder_pair

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ["mcp/__init__.py", "mcp/server.py", "mcp/file_server.py",
          "mcp/search_server.py", "tools/mcp_client.py"]

PKGS = {
    "jax": types.SimpleNamespace(
        MCPServer=j_server.MCPServer, Files=j_file.FileOperationsServer,
        Search=j_search.SearchMCPServer, MCPClient=j_client.MCPClient,
        mcp_tool=j_client.mcp_tool, Tool=j_registry.Tool,
        HTTPServer=j_http.HTTPServer, Router=j_http.Router),
    "torch": types.SimpleNamespace(
        MCPServer=t_server.MCPServer, Files=t_file.FileOperationsServer,
        Search=t_search.SearchMCPServer, MCPClient=t_client.MCPClient,
        mcp_tool=t_client.mcp_tool, Tool=t_registry.Tool,
        HTTPServer=t_http.HTTPServer, Router=t_http.Router),
}


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


def rpc(server, method, params=None, *, msg_id=1, api_key=None):
    return asyncio.run(server.handle(
        {"jsonrpc": "2.0", "id": msg_id, "method": method,
         "params": params or {}}, api_key=api_key))


def both(fn, *args):
    """``fn(package, *args)`` on each package; the two results."""
    return fn(PKGS["jax"], *args), fn(PKGS["torch"], *args)


def same(fn, *args):
    want, got = both(fn, *args)
    assert got == want
    return got


# ------------------------------------------------------ tests/test_mcp.py


def test_initialize_and_builtin_tools():
    def run(m):
        s = m.MCPServer("t")
        return [rpc(s, "initialize"), rpc(s, "tools/list"),
                rpc(s, "tools/call", {"name": "health"}),
                rpc(s, "resources/list"), rpc(s, "ping")]

    out = same(run)
    names = [t["name"] for t in out[1]["result"]["tools"]]
    assert "health" in names and "info" in names
    assert json.loads(out[2]["result"]["content"][0]["text"])["status"] == "ok"


def test_unknown_method_and_tool():
    def run(m):
        s = m.MCPServer("t")
        return [rpc(s, "bogus/method"),
                rpc(s, "tools/call", {"name": "nope"})]

    out = same(run)
    assert out[0]["error"]["code"] == -32601
    assert out[1]["error"]["code"] == -32602


def _sandbox_replies(m, root):
    root.mkdir()
    (root / "hello.txt").write_text("hi")
    (root / "link").symlink_to("/etc")
    s = m.Files([str(root)])
    calls = [("read_file", {"path": str(root / "hello.txt")}),
             ("read_file", {"path": "/etc/passwd"}),
             ("list_dir", {"path": str(root / "link")}),
             ("write_file", {"path": str(root / "new/file.txt"),
                             "content": "data"}),
             ("read_file", {"path": str(root / "new/file.txt")}),
             ("stat", {"path": str(root / "hello.txt")}),
             ("make_dir", {"path": str(root / "d1")}),
             ("delete_path", {"path": str(root / "d1")})]
    out = [rpc(s, "tools/call", {"name": n, "arguments": a})
           for n, a in calls]
    text = json.dumps(out).replace(str(root), "<root>")
    return json.loads(re.sub(r'\\"mtime\\": [0-9.e+]+', "", text))


def test_file_server_sandbox(tmp_path):
    want = _sandbox_replies(PKGS["jax"], tmp_path / "j")
    got = _sandbox_replies(PKGS["torch"], tmp_path / "t")
    assert got == want
    assert json.loads(got[0]["result"]["content"][0]["text"])["content"] \
        == "hi"
    assert got[1]["result"]["isError"]
    assert "outside allowed" in got[1]["result"]["content"][0]["text"]
    assert got[2]["result"]["isError"]
    assert (tmp_path / "t/new/file.txt").read_text() == "data"


def test_permission_levels(tmp_path):
    def run(m, root):
        root.mkdir()
        (root / "gone.txt").write_text("x")
        s = m.Files([str(root)], api_keys={"rkey": "read", "akey": "admin"})
        out = [rpc(s, "tools/call", {"name": "health"}),
               rpc(s, "tools/call", {"name": "write_file", "arguments": {
                   "path": str(root / "x"), "content": "y"}},
                   api_key="rkey"),
               rpc(s, "tools/list", api_key="rkey"),
               rpc(s, "tools/list", api_key="akey"),
               rpc(s, "tools/list", api_key="bogus"),
               rpc(s, "tools/call", {"name": "delete_path", "arguments": {
                   "path": str(root / "gone.txt")}}, api_key="akey")]
        return json.loads(json.dumps(out).replace(str(root), "<root>"))

    want = run(PKGS["jax"], tmp_path / "j")
    got = run(PKGS["torch"], tmp_path / "t")
    assert got == want
    assert got[0]["error"]["code"] == -32001
    assert got[1]["error"]["code"] == -32001
    tools = [t["name"] for t in got[2]["result"]["tools"]]
    assert "write_file" not in tools and "read_file" in tools
    assert not got[5]["result"]["isError"]


DIM = 32
ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=32, out_dim=DIM, dtype="float32")
TEXTS = ["the fox jumped the fence", "a quick brown dog sleeps",
         "fences keep foxes out of gardens", "retrieval over hybrid search"]


def small_config(cls, index, sparse, funnel):
    cfg = cls()
    cfg.index = index(dim=DIM, matryoshka_dims=(8, 16), initial_capacity=16)
    cfg.sparse = sparse(candidate_pool=64, max_query_terms=8)
    cfg.funnel = funnel(matryoshka_limits=(8, 6), dense_limit=5,
                        quantized_limit=5, sparse_limit=5, final_limit=5)
    return cfg


def search_pair():
    """(JAX server, port server) over the same chunks, encoder weights and
    dense tables."""
    jemb, temb = embedder_pair(ECFG, seed=3)
    jcol = JCollection("m", small_config(JConfig, JIndexConfig,
                                         JSparseConfig, JFunnelConfig))
    tcol = Collection("m", small_config(Config, IndexConfig, SparseConfig,
                                        FunnelConfig), device="cpu")
    for i, t in enumerate(TEXTS):
        jcol.store_document_vectors(f"d{i}", [{"text": t}], jemb.encode([t]))
        tcol.store_document_vectors(f"d{i}", [{"text": t}], temb.encode([t]))
    carry_collection(jcol, tcol)
    jkg = JKGStore(JKGConfig(max_degree=8), dim=DIM)
    tkg = KGStore(KGConfig(max_degree=8), dim=DIM, device="cpu")
    return (PKGS["jax"].Search(jcol, jkg, jemb),
            PKGS["torch"].Search(tcol, tkg, temb))


def assert_hits_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= 1e-5


def test_search_mcp_server():
    js, ts = search_pair()
    jl, tl = rpc(js, "tools/list"), rpc(ts, "tools/list")
    assert tl == jl
    tools = [t["name"] for t in tl["result"]["tools"]]
    assert "hybrid_search" in tools and len(tools) >= 21
    for query in ("fox fence", "hybrid retrieval", "dog"):
        call = {"name": "hybrid_search", "arguments": {"query": query}}
        jr, tr = rpc(js, "tools/call", call), rpc(ts, "tools/call", call)
        want = json.loads(jr["result"]["content"][0]["text"])
        got = json.loads(tr["result"]["content"][0]["text"])
        assert_hits_close(got, want)
    assert "fox" in got[0]["text"] or query != "fox fence"
    for call in ({"name": "list_documents", "arguments": {}},
                 {"name": "find_entities_by_type",
                  "arguments": {"entity_type": "PERSON"}}):
        assert rpc(ts, "tools/call", call) == rpc(js, "tools/call", call)
    r = rpc(ts, "resources/read", {"uri": "stats://collection"})
    assert r == rpc(js, "resources/read", {"uri": "stats://collection"})
    assert json.loads(r["result"]["contents"][0]["text"])["chunks"] == 4


def test_mcp_over_http():
    def run(m):
        async def main():
            router = m.Router()
            s = m.MCPServer("http-test")
            s.attach_http(router)
            server = m.HTTPServer(router, port=0)
            port = await server.start()
            try:
                async with httpx.AsyncClient(
                        base_url=f"http://127.0.0.1:{port}") as c:
                    r1 = await c.post("/mcp", json={
                        "jsonrpc": "2.0", "id": 1, "method": "tools/list"})
                    r2 = await c.post("/mcp", json=[
                        {"jsonrpc": "2.0", "id": 1, "method": "ping"},
                        {"jsonrpc": "2.0", "id": 2, "method": "ping"}])
                    r3 = await c.post("/mcp", content=b"not json")
                    return [(r.status_code, r.json()) for r in (r1, r2, r3)]
            finally:
                await server.stop()
        return asyncio.run(main())

    out = same(run)
    assert "health" in [t["name"] for t in out[0][1]["result"]["tools"]]
    assert len(out[1][1]) == 2


def test_serve_stdio_transport(tmp_path):
    def run(m, root):
        root.mkdir()
        (root / "f.txt").write_text("hello stdio")
        srv = m.Files(allowed_dirs=[str(root)])
        lines = [
            json.dumps({"jsonrpc": "2.0", "id": 1, "method": "initialize",
                        "params": {}}),
            "this is not json",
            json.dumps({"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                        "params": {"name": "read_file", "arguments": {
                            "path": str(root / "f.txt")}}}),
        ]
        stdout = io.StringIO()
        asyncio.run(srv.serve_stdio(stdin=io.StringIO("\n".join(lines)
                                                      + "\n"),
                                    stdout=stdout))
        return stdout.getvalue().replace(str(root), "<root>")

    want = run(PKGS["jax"], tmp_path / "j")
    got = run(PKGS["torch"], tmp_path / "t")
    assert got == want
    out = [json.loads(line) for line in got.splitlines()]
    assert len(out) == 2 and "hello stdio" in json.dumps(out[1])


# ------------------------------------- tests/test_web_tools.py (MCP cases)


def test_mcp_client_inprocess_and_batch():
    def run(m):
        async def main():
            s1 = m.MCPServer("alpha")
            s1.add_tool(m.Tool("double", "", {"type": "object", "properties": {
                "x": {"type": "integer"}}}, lambda x: {"doubled": x * 2}))
            s2 = m.MCPServer("beta")
            client = m.MCPClient()
            client.add_inprocess("alpha", s1)
            client.add_inprocess("beta", s2)
            out = [await client.list_tools(),
                   await client.call("alpha", "double", {"x": 21}),
                   await client.call_batch([
                       {"server": "alpha", "tool": "double",
                        "arguments": {"x": 1}},
                       {"server": "beta", "tool": "health"},
                       {"server": "alpha", "tool": "missing"},
                       {"server": "gamma", "tool": "health"}])]
            try:
                await client.call("alpha", "missing")
            except RuntimeError as e:
                out.append(str(e))
            return out
        return asyncio.run(main())

    out = same(run)
    assert "double" in out[0]["alpha"] and "health" in out[0]["beta"]
    assert out[1] == {"doubled": 42}
    assert out[2][0] == {"doubled": 2} and out[2][1]["status"] == "ok"
    assert "error" in out[2][2] and "error" in out[2][3]


def test_mcp_agent_tool():
    def run(m):
        async def main():
            s = m.MCPServer("srv")
            client = m.MCPClient()
            client.add_inprocess("srv", s)
            t = m.mcp_tool(client)
            return [t.schema, await t.call(action="list"),
                    await t.call(action="call", server="srv", tool="health"),
                    await t.call(action="bogus")]
        return asyncio.run(main())

    out = same(run)
    assert "srv" in out[1] and out[2]["status"] == "ok"


def test_mcp_client_http_transport():
    def run(m):
        async def main():
            router = m.Router()
            s = m.MCPServer("remote", api_keys={"k": "admin"})
            s.attach_http(router)
            server = m.HTTPServer(router, port=0)
            port = await server.start()
            try:
                url = f"http://127.0.0.1:{port}/mcp"
                client = m.MCPClient.from_config({"servers": {
                    "remote": {"url": url, "api_key": "k"},
                    "nokey": {"url": url}}})
                try:
                    return [await client.list_tools(),
                            await client.call("remote", "health")]
                finally:  # the server's stop waits for open connections
                    await client._client().aclose()
            finally:
                await server.stop()
        return asyncio.run(main())

    out = same(run)
    assert "health" in out[0]["remote"] and "error" in out[0]["nokey"]


def test_search_server_through_client_inprocess_and_http():
    """The port's search server reached through `MCPClient.add_inprocess`
    and over HTTP at /mcp: equal results."""
    _, ts = search_pair()

    async def main():
        router = PKGS["torch"].Router()
        ts.attach_http(router)
        server = PKGS["torch"].HTTPServer(router, port=0)
        port = await server.start()
        try:
            client = PKGS["torch"].MCPClient()
            client.add_inprocess("local", ts)
            client.add_http("http", f"http://127.0.0.1:{port}/mcp")
            args = {"query": "fox fence", "k": 3}
            try:
                return (await client.list_tools(),
                        await client.call("local", "hybrid_search", args),
                        await client.call("http", "hybrid_search", args))
            finally:  # the server's stop waits for open connections
                await client._client().aclose()
        finally:
            await server.stop()

    tools, a, b = asyncio.run(main())
    assert tools["local"] == tools["http"] and "hybrid_search" in tools["http"]
    assert a == b and a
