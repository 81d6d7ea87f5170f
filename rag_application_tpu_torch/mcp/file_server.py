"""File-operations MCP server with sandboxed directory enforcement.

Copy of `rag_application_tpu/mcp/file_server.py`.

Parity: McpServer/app/servers/file-operations/src/server.py:94-424 —
read/write/list/stat/mkdir/delete tools restricted to an allowed-dirs
sandbox; write/delete require elevated permission.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

from ..tools.registry import Tool
from .server import MCPServer, requires_permission

_PATH = {"type": "object",
         "properties": {"path": {"type": "string"}}, "required": ["path"]}


class FileOperationsServer(MCPServer):
    def __init__(self, allowed_dirs: List[str], *,
                 api_keys: Optional[Dict[str, str]] = None,
                 max_read_bytes: int = 4 * 1024 * 1024):
        super().__init__("file-operations", api_keys=api_keys)
        self.allowed = [os.path.realpath(d) for d in allowed_dirs]
        self.max_read_bytes = max_read_bytes
        self._register()

    def _resolve(self, path: str) -> str:
        """Resolve + enforce the sandbox (parity: allowed-dir checks,
        server.py:94-130). Symlink escapes are caught by realpath."""
        real = os.path.realpath(path)
        for root in self.allowed:
            if real == root or real.startswith(root + os.sep):
                return real
        raise PermissionError(f"path outside allowed directories: {path}")

    def _register(self) -> None:
        def read_file(path: str):
            p = self._resolve(path)
            size = os.path.getsize(p)
            if size > self.max_read_bytes:
                raise ValueError(f"file too large ({size} bytes)")
            with open(p, "r", errors="replace") as f:
                return {"path": p, "content": f.read()}

        def list_dir(path: str):
            p = self._resolve(path)
            entries = []
            for name in sorted(os.listdir(p)):
                full = os.path.join(p, name)
                entries.append({"name": name,
                                "type": "dir" if os.path.isdir(full) else "file",
                                "size": os.path.getsize(full)
                                if os.path.isfile(full) else None})
            return {"path": p, "entries": entries}

        def stat_file(path: str):
            p = self._resolve(path)
            st = os.stat(p)
            return {"path": p, "size": st.st_size, "mtime": st.st_mtime,
                    "is_dir": os.path.isdir(p)}

        @requires_permission("write")
        def write_file(path: str, content: str):
            p = self._resolve(path)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w") as f:
                f.write(content)
            return {"path": p, "bytes": len(content.encode())}

        @requires_permission("write")
        def make_dir(path: str):
            p = self._resolve(path)
            os.makedirs(p, exist_ok=True)
            return {"path": p, "created": True}

        @requires_permission("admin")
        def delete_path(path: str):
            p = self._resolve(path)
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.remove(p)
            return {"path": p, "deleted": True}

        self.add_tool(Tool("read_file", "Read a text file.", _PATH, read_file))
        self.add_tool(Tool("list_dir", "List a directory.", _PATH, list_dir))
        self.add_tool(Tool("stat", "Stat a path.", _PATH, stat_file))
        self.add_tool(Tool(
            "write_file", "Write a text file (write permission).",
            {"type": "object", "properties": {
                "path": {"type": "string"}, "content": {"type": "string"}},
             "required": ["path", "content"]}, write_file))
        self.add_tool(Tool("make_dir", "Create a directory (write permission).",
                           _PATH, make_dir))
        self.add_tool(Tool("delete_path",
                           "Delete a file or directory (admin permission).",
                           _PATH, delete_path))
