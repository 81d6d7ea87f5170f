"""Corpus-axis sharding over a device mesh.

Port of `rag_application_tpu/parallel/__init__.py`."""

from .mesh import make_mesh, param_shardings, batch_sharding, replicated

__all__ = ["make_mesh", "param_shardings", "batch_sharding", "replicated"]
