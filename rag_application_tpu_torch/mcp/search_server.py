"""Search MCP server: the retrieval engine as MCP tools/resources.

Copy of `rag_application_tpu/mcp/search_server.py`, over the port's
`Collection`, `KGStore` and `KnowledgeSearchToolbox`.

Parity: mcp_server/qdrant_search_mcp_server.py — a standalone FastMCP
server exposing the monolith's hybrid-search REST surface as MCP tools
and resources (:36-80+). Here the tools call the engine in-process: the
whole 21-tool knowledge toolbox plus collection stats as a resource.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..kg.store import KGStore
from ..store.collection import Collection
from ..tools.knowledge import KnowledgeSearchToolbox
from .server import MCPServer


class SearchMCPServer(MCPServer):
    def __init__(self, collection: Collection, kg: KGStore, embedder, *,
                 api_keys: Optional[Dict[str, str]] = None):
        super().__init__("rag-tpu-search", api_keys=api_keys)
        toolbox = KnowledgeSearchToolbox(collection, kg, embedder).build()
        for name in toolbox.names():
            self.add_tool(toolbox.get(name))
        self.add_resource(
            "stats://collection",
            lambda: {"chunks": collection.chunk_count(), **kg.stats()})
