"""MCP (Model Context Protocol) server framework.

Copy of `rag_application_tpu/mcp/server.py`.

Parity: the reference's FastMCP base server with health/info tools and
permission decorators (McpServer/app/core/base_server/src/server.py:8-80)
plus its API-key/JWT auth middleware with permission levels
(middleware.py). Implemented as JSON-RPC 2.0 dispatch (the MCP wire
protocol): initialize, tools/list, tools/call, resources/list,
resources/read — servable over stdio (`serve_stdio`) or mounted on the
framework's HTTP server at /mcp (`attach_http`, MCP streamable-http
style).
"""

from __future__ import annotations

import asyncio
import json
import sys
from typing import Any, Callable, Dict, Optional

from ..tools.registry import Tool, ToolRegistry

PERMISSION_LEVELS = {"read": 0, "write": 1, "admin": 2}


def requires_permission(level: str):
    """Mark a tool function with a required permission level."""

    def deco(fn):
        fn.__mcp_permission__ = level
        return fn

    return deco


class MCPServer:
    protocol_version = "2024-11-05"

    def __init__(self, name: str, version: str = "0.1.0", *,
                 api_keys: Optional[Dict[str, str]] = None):
        """api_keys: key -> permission level ("read"/"write"/"admin");
        None disables auth."""
        self.name = name
        self.version = version
        self.api_keys = api_keys
        self.tools = ToolRegistry()
        self.resources: Dict[str, Callable[[], Any]] = {}
        # built-ins (parity: health/info tools, server.py:8-80)
        self.tools.add(Tool("health", "Server health check.",
                            {"type": "object", "properties": {}},
                            lambda: {"status": "ok", "server": self.name}))
        self.tools.add(Tool("info", "Server info and capabilities.",
                            {"type": "object", "properties": {}},
                            lambda: {"name": self.name,
                                     "version": self.version,
                                     "tools": self.tools.names()}))

    def add_tool(self, t: Tool) -> None:
        self.tools.add(t)

    def add_resource(self, uri: str, reader: Callable[[], Any]) -> None:
        self.resources[uri] = reader

    # --------------------------------------------------------------- auth

    def _level(self, key: Optional[str]) -> int:
        if self.api_keys is None:
            return PERMISSION_LEVELS["admin"]
        if key is None or key not in self.api_keys:
            return -1
        return PERMISSION_LEVELS.get(self.api_keys[key], 0)

    def _tool_level(self, t: Tool) -> int:
        lvl = getattr(t.fn, "__mcp_permission__", "read")
        return PERMISSION_LEVELS.get(lvl, 0)

    # ------------------------------------------------------------ dispatch

    async def handle(self, message: Dict[str, Any],
                     *, api_key: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Handle one JSON-RPC message; returns the response (None for
        notifications)."""
        msg_id = message.get("id")
        method = message.get("method", "")
        params = message.get("params") or {}

        def ok(result):
            return {"jsonrpc": "2.0", "id": msg_id, "result": result}

        def err(code, text):
            return {"jsonrpc": "2.0", "id": msg_id,
                    "error": {"code": code, "message": text}}

        if method == "initialize":
            return ok({
                "protocolVersion": self.protocol_version,
                "serverInfo": {"name": self.name, "version": self.version},
                "capabilities": {"tools": {}, "resources": {}},
            })
        if "id" not in message or method.startswith("notifications/"):
            # JSON-RPC forbids RESPONDING to notifications — unknown
            # ones (notifications/cancelled etc.) are ignored, not
            # answered with an id:null error
            return None
        if method == "ping":
            return ok({})
        caller_level = self._level(api_key)
        if caller_level < 0:
            return err(-32001, "unauthorized")
        if method == "tools/list":
            tools = []
            for name in self.tools.names():
                t = self.tools.get(name)
                if self._tool_level(t) <= caller_level:
                    tools.append({"name": t.name,
                                  "description": t.description,
                                  "inputSchema": t.schema})
            return ok({"tools": tools})
        if method == "tools/call":
            name = params.get("name", "")
            t = self.tools.get(name)
            if t is None:
                return err(-32602, f"unknown tool {name}")
            if self._tool_level(t) > caller_level:
                return err(-32001, f"permission denied for {name}")
            try:
                result = await t.call(**(params.get("arguments") or {}))
            except Exception as e:  # noqa: BLE001 — protocol boundary
                return ok({"content": [{"type": "text", "text": str(e)}],
                           "isError": True})
            if not isinstance(result, str):
                result = json.dumps(result, default=str)
            return ok({"content": [{"type": "text", "text": result}],
                       "isError": False})
        if method == "resources/list":
            return ok({"resources": [{"uri": u, "name": u}
                                     for u in sorted(self.resources)]})
        if method == "resources/read":
            uri = params.get("uri", "")
            reader = self.resources.get(uri)
            if reader is None:
                return err(-32602, f"unknown resource {uri}")
            try:  # protocol boundary: a failing reader (deleted backing
                # file, ...) must answer, not kill the serve loop
                data = reader()
            except Exception as e:  # noqa: BLE001
                return err(-32603, f"resource read failed: {e}")
            if not isinstance(data, str):
                data = json.dumps(data, default=str)
            return ok({"contents": [{"uri": uri, "mimeType": "text/plain",
                                     "text": data}]})
        return err(-32601, f"method not found: {method}")

    # ------------------------------------------------------------- serving

    async def serve_stdio(self, stdin=None, stdout=None) -> None:
        """Line-delimited JSON-RPC over stdio (the MCP stdio transport).

        stdio is a LOCAL transport — the parent process that spawned us
        already holds the trust boundary, so calls run at admin level
        (with api_keys configured there would otherwise be no way to
        authenticate over stdio at all; keys gate the HTTP transport)."""
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        loop = asyncio.get_running_loop()
        admin = next((k for k, lvl in (self.api_keys or {}).items()
                      if lvl == "admin"), None)
        while True:
            line = await loop.run_in_executor(None, stdin.readline)
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = await self.handle(msg, api_key=admin)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()

    def attach_http(self, router, path: str = "/mcp") -> None:
        """Mount as streamable-http on the framework's Router."""
        from ..api.http import JSONResponse, Request

        async def endpoint(req: Request):
            key = req.headers.get("x-api-key")
            try:
                msg = req.json()
            except Exception:  # noqa: BLE001 — malformed body
                msg = None
            if msg is None or not isinstance(msg, (dict, list)):
                return JSONResponse({
                    "jsonrpc": "2.0", "id": None,
                    "error": {"code": -32700, "message": "parse error"}})
            if isinstance(msg, list):  # batch
                out = [await self.handle(m, api_key=key) for m in msg
                       if isinstance(m, dict)]
                return JSONResponse([r for r in out if r is not None])
            resp = await self.handle(msg, api_key=key)
            return JSONResponse(resp if resp is not None else {})

        router.add("POST", path, endpoint)
