"""Minimal async HTTP/1.1 server + router.

Copy of `rag_application_tpu/api/http.py`.

The reference serves its four APIs with FastAPI/uvicorn; this image has
neither, so the framework owns a small, dependency-free server: asyncio
streams, path-pattern routing ({param} segments), JSON bodies, SSE
streaming for the chat endpoint, and HTTP/1.1 keep-alive (bounded by
requests/connection and an idle timeout) so serving loops amortize the
TCP handshake across requests. SSE responses still close their
connection — the stream owns it until [DONE].
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("rag_application_tpu.api")

MAX_BODY = 256 * 1024 * 1024  # chunked uploads cap (reference: 50MB chunks)
KEEPALIVE_MAX_REQUESTS = 1000
KEEPALIVE_IDLE_S = 75.0


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes
    params: Dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body)


@dataclass
class Response:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    _REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request",
                401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed",
                422: "Unprocessable Entity", 500: "Internal Server Error"}

    def render_head(self, *, keep_alive: bool = False) -> bytes:
        reason = self._REASONS.get(self.status, "Unknown")
        head = [f"HTTP/1.1 {self.status} {reason}"]
        headers = {"content-length": str(len(self.body)),
                   "connection": "keep-alive" if keep_alive else "close",
                   **self.headers}
        head += [f"{k}: {v}" for k, v in headers.items()]
        return ("\r\n".join(head) + "\r\n\r\n").encode()


def JSONResponse(data: Any, status: int = 200) -> Response:
    return Response(status=status,
                    headers={"content-type": "application/json"},
                    body=json.dumps(data, default=str).encode())


@dataclass
class SSEResponse:
    """Server-sent events: handler returns this wrapping an async
    generator of dicts (or raw strings)."""

    events: AsyncIterator[Any]
    headers: Dict[str, str] = field(default_factory=dict)


Handler = Callable[[Request], Awaitable[Any]]


class Router:
    def __init__(self):
        self._routes: List[Tuple[str, List[str], Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method.upper(), pattern.strip("/").split("/"),
                             handler))

    def route(self, method: str, pattern: str):
        def deco(fn):
            self.add(method, pattern, fn)
            return fn
        return deco

    def match(self, method: str, path: str) -> Tuple[Optional[Handler], Dict[str, str], bool]:
        """Returns (handler, params, path_exists)."""
        segments = path.strip("/").split("/")
        path_exists = False
        for m, pat, handler in self._routes:
            if len(pat) != len(segments):
                continue
            params = {}
            ok = True
            for p, s in zip(pat, segments):
                if p.startswith("{") and p.endswith("}"):
                    params[p[1:-1]] = urllib.parse.unquote(s)
                elif p != s:
                    ok = False
                    break
            if ok:
                path_exists = True
                if m == method:
                    return handler, params, True
        return None, {}, path_exists


class HTTPServer:
    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 8080):
        self.router = router
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            request_line = await reader.readline()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            return None
        if not request_line:
            return None
        try:
            method, target, _ = request_line.decode().split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0"))
        if length > MAX_BODY:
            return None
        try:
            # a client aborting mid-upload raises IncompleteReadError here
            body = await reader.readexactly(length) if length else b""
        except (ConnectionResetError, asyncio.IncompleteReadError):
            return None
        parsed = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        return Request(method=method.upper(), path=parsed.path, query=query,
                       headers=headers, body=body)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            for served in range(KEEPALIVE_MAX_REQUESTS):
                try:
                    req = await asyncio.wait_for(
                        self._read_request(reader),
                        KEEPALIVE_IDLE_S if served else None)
                except asyncio.TimeoutError:
                    return
                if req is None:
                    return
                handler, params, exists = self.router.match(
                    req.method, req.path)
                if handler is None:
                    resp = JSONResponse(
                        {"detail": "Method Not Allowed" if exists
                         else "Not Found"},
                        405 if exists else 404)
                else:
                    req.params = params
                    try:
                        resp = await handler(req)
                    except json.JSONDecodeError as e:
                        resp = JSONResponse(
                            {"detail": f"invalid JSON: {e}"}, 422)
                    except (KeyError, TypeError, ValueError) as e:
                        resp = JSONResponse({"detail": str(e)}, 422)
                    except Exception as e:  # noqa: BLE001 — boundary
                        logger.exception("handler error")
                        resp = JSONResponse({"detail": str(e)}, 500)

                if isinstance(resp, SSEResponse):
                    # the stream owns the connection until [DONE]
                    head = ("HTTP/1.1 200 OK\r\n"
                            "content-type: text/event-stream\r\n"
                            "cache-control: no-cache\r\n"
                            "connection: close\r\n"
                            + "".join(f"{k}: {v}\r\n"
                                      for k, v in resp.headers.items())
                            + "\r\n").encode()
                    writer.write(head)
                    await writer.drain()
                    async for event in resp.events:
                        if not isinstance(event, str):
                            event = json.dumps(event, default=str)
                        writer.write(f"data: {event}\n\n".encode())
                        await writer.drain()
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    return
                if isinstance(resp, dict):
                    resp = JSONResponse(resp)
                keep = (req.headers.get("connection", "").lower() != "close"
                        and served + 1 < KEEPALIVE_MAX_REQUESTS
                        # bodies are only framed by Content-Length here;
                        # a chunked body would desync the stream (its
                        # bytes would parse as the next request line),
                        # so such connections close after the response
                        # and the unread body is discarded with them
                        and "transfer-encoding" not in req.headers)
                writer.write(resp.render_head(keep_alive=keep) + resp.body)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        logger.info("serving on %s:%s", self.host, self.port)
        async with self._server:
            await self._server.serve_forever()
