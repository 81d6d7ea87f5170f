"""MCP multi-server client tool.

Copy of `rag_application_tpu/tools/mcp_client.py`.

Parity: the reference's MCP tool — a client over multiple MCP servers
configured by JSON, with tool discovery and batch requests
(AgentAPI/app/tools/core_tools/mcp/mcp_tool.py:43-352). Servers are
addressed by name; transports: in-process (`server` objects from
rag_application_tpu.mcp) or streamable-http endpoints.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from typing import Any, Dict, List, Optional

from .registry import Tool


class MCPClient:
    def __init__(self):
        self._servers: Dict[str, Dict[str, Any]] = {}
        self._ids = itertools.count(1)

    # --------------------------------------------------------- transports

    def add_inprocess(self, name: str, server, *,
                      api_key: Optional[str] = None) -> None:
        self._servers[name] = {"kind": "inprocess", "server": server,
                               "api_key": api_key}

    def add_http(self, name: str, url: str, *,
                 api_key: Optional[str] = None) -> None:
        self._servers[name] = {"kind": "http", "url": url, "api_key": api_key}

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "MCPClient":
        """JSON config: {"servers": {name: {"url": ...,
        "api_key": ...}}} (parity: mcp_tool JSON config)."""
        c = cls()
        for name, spec in (config.get("servers") or {}).items():
            c.add_http(name, spec["url"], api_key=spec.get("api_key"))
        return c

    async def _rpc(self, name: str, method: str,
                   params: Optional[Dict[str, Any]] = None) -> Any:
        spec = self._servers.get(name)
        if spec is None:
            raise KeyError(f"unknown MCP server {name}; "
                           f"known: {sorted(self._servers)}")
        msg = {"jsonrpc": "2.0", "id": next(self._ids), "method": method,
               "params": params or {}}
        if spec["kind"] == "inprocess":
            resp = await spec["server"].handle(msg, api_key=spec["api_key"])
        else:
            headers = {}
            if spec["api_key"]:
                headers["x-api-key"] = spec["api_key"]
            r = await self._client().post(spec["url"], json=msg,
                                          headers=headers)
            r.raise_for_status()
            resp = r.json()
        if resp and "error" in resp:
            raise RuntimeError(resp["error"].get("message", "MCP error"))
        return (resp or {}).get("result")

    # ---------------------------------------------------------------- API

    def _client(self):
        """One keep-alive AsyncClient per event loop (a per-RPC client
        paid a TCP/TLS handshake for every call in a batch)."""
        import httpx

        loop = asyncio.get_running_loop()
        if getattr(self, "_client_loop", None) is not loop:
            self._client_obj = httpx.AsyncClient(timeout=60)
            self._client_loop = loop
        return self._client_obj

    async def list_tools(self, server: Optional[str] = None) -> Dict[str, List[str]]:
        """Tool names per server — queried CONCURRENTLY, one failing
        server reports {"error": ...} instead of hiding the rest."""
        names = [server] if server else list(self._servers)

        async def one(n):
            try:
                result = await self._rpc(n, "tools/list")
                return [t["name"] for t in (result or {}).get("tools", [])]
            except Exception as e:  # noqa: BLE001 — per-server capture
                return {"error": str(e)}

        results = await asyncio.gather(*(one(n) for n in names))
        return dict(zip(names, results))

    async def call(self, server: str, tool: str,
                   arguments: Optional[Dict[str, Any]] = None) -> Any:
        result = await self._rpc(server, "tools/call",
                                 {"name": tool, "arguments": arguments or {}})
        text = "".join(c.get("text", "")
                       for c in (result or {}).get("content", []))
        if (result or {}).get("isError"):
            raise RuntimeError(text)
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            return text

    async def call_batch(self, requests: List[Dict[str, Any]]) -> List[Any]:
        """Concurrent batch (parity: batch requests, mcp_tool.py).
        Each request: {"server", "tool", "arguments"}; errors surface as
        {"error": ...} entries, not exceptions."""

        async def one(r):
            try:
                return await self.call(r["server"], r["tool"],
                                       r.get("arguments"))
            except Exception as e:  # noqa: BLE001
                return {"error": str(e)}

        return list(await asyncio.gather(*(one(r) for r in requests)))


def mcp_tool(client: MCPClient) -> Tool:
    """The agent-facing tool: discover and call MCP tools across servers."""

    async def mcp(action: str, server: str = "", tool: str = "",
                  arguments: str = "{}"):
        if action == "list":
            return await client.list_tools(server or None)
        if action == "call":
            return await client.call(server, tool, json.loads(arguments or "{}"))
        return {"error": "action must be 'list' or 'call'"}

    return Tool(
        "mcp", "Interact with connected MCP servers: list tools or call one.",
        {"type": "object", "properties": {
            "action": {"type": "string", "enum": ["list", "call"]},
            "server": {"type": "string", "default": ""},
            "tool": {"type": "string", "default": ""},
            "arguments": {"type": "string", "default": "{}"}},
         "required": ["action"]},
        mcp)
