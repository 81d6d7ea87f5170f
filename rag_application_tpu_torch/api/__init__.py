"""Copy of `rag_application_tpu/api/__init__.py`."""

from .http import HTTPServer, JSONResponse, Request, Response, Router, SSEResponse
from .app import build_app

__all__ = [
    "HTTPServer",
    "Router",
    "Request",
    "Response",
    "JSONResponse",
    "SSEResponse",
    "build_app",
]
