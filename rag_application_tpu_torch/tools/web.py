"""Web search + scrape tools with pluggable backends.

Copy of `rag_application_tpu/tools/web.py`.

Parity: the reference's SearxNG web search (AgentAPI/app/tools/core_tools/
web_search/web_search_tool.py:100) and ScrapegraphAI scraping
(web_scrape_tool.py:87-134). Both depend on external services; here the
transport is a pluggable async backend — the default talks to a SearxNG
instance / fetches pages over httpx, and tests inject offline stubs. The
tool surface (names, arg schemas, result shapes) is what agents bind.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional

from .registry import Tool

_TAG_RE = re.compile(r"<(script|style)[^>]*>.*?</\1>", re.S | re.I)
_HTML_RE = re.compile(r"<[^>]+>")
_WS_RE = re.compile(r"[ \t]*\n[ \t\n]*")


def html_to_text(html: str) -> str:
    """Small readability pass: drop script/style, strip tags, decode
    entities (ALL of them — stdlib html.unescape, not a hand-rolled
    subset), fold space."""
    import html as _html

    text = _TAG_RE.sub(" ", html)
    text = re.sub(r"<br\s*/?>|</p>|</div>|</h[1-6]>", "\n", text, flags=re.I)
    text = _HTML_RE.sub(" ", text)
    text = _html.unescape(text).replace("\xa0", " ")  # nbsp -> space
    text = re.sub(r"[ \t]+", " ", text)
    return _WS_RE.sub("\n", text).strip()


def make_searxng_backend(base_url: str, *, timeout: float = 20.0):
    """Default search backend: a SearxNG instance's JSON API."""

    async def search(query: str, k: int) -> List[Dict[str, Any]]:
        import httpx

        async with httpx.AsyncClient(timeout=timeout) as client:
            r = await client.get(f"{base_url}/search",
                                 params={"q": query, "format": "json"})
            r.raise_for_status()
            out = []
            for item in r.json().get("results", [])[:k]:
                out.append({"title": item.get("title"),
                            "url": item.get("url"),
                            "snippet": item.get("content")})
            return out

    return search


def make_http_fetch_backend(*, timeout: float = 30.0,
                            max_bytes: int = 2 * 1024 * 1024):
    async def fetch(url: str) -> str:
        import httpx

        async with httpx.AsyncClient(timeout=timeout,
                                     follow_redirects=True) as client:
            # stream + stop at the byte budget: agents pass arbitrary
            # URLs, and a full .get() would download (and hold) an
            # unbounded body before any slice applied
            async with client.stream("GET", url) as r:
                r.raise_for_status()
                buf = bytearray()
                async for chunk in r.aiter_bytes():
                    buf.extend(chunk)
                    if len(buf) >= max_bytes:
                        break
                return bytes(buf[:max_bytes]).decode(
                    r.encoding or "utf-8", errors="replace")

    return fetch


def web_search_tool(backend: Optional[Callable] = None, *,
                    searxng_url: str = "http://localhost:8888") -> Tool:
    backend = backend or make_searxng_backend(searxng_url)

    async def web_search(query: str, k: int = 5):
        return await backend(query, k)

    return Tool(
        "web_search", "Search the web; returns titles, urls and snippets.",
        {"type": "object", "properties": {
            "query": {"type": "string"},
            "k": {"type": "integer", "default": 5}}, "required": ["query"]},
        web_search)


def web_scrape_tool(fetch_backend: Optional[Callable] = None) -> Tool:
    fetch = fetch_backend or make_http_fetch_backend()

    async def web_scrape(url: str, max_chars: int = 8000):
        html = await fetch(url)
        return {"url": url, "text": html_to_text(html)[:max_chars]}

    return Tool(
        "web_scrape", "Fetch a web page and return readable text.",
        {"type": "object", "properties": {
            "url": {"type": "string"},
            "max_chars": {"type": "integer", "default": 8000}},
         "required": ["url"]},
        web_scrape)
