"""Copy of `rag_application_tpu/mcp/__init__.py`."""

from .server import MCPServer, requires_permission
from .file_server import FileOperationsServer
from .search_server import SearchMCPServer

__all__ = ["MCPServer", "requires_permission", "FileOperationsServer",
           "SearchMCPServer"]
