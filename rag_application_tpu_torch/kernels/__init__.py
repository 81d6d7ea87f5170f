"""The port's CUDA kernels: `kernels.build` compiles csrc/ into one
shared library; `launch` calls one of its C entry points."""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from .build import load

__all__ = ["count_launch", "launch", "load", "ptr"]

# two threads may launch at once (the micro-batcher keeps two groups in
# flight): the counts' read-modify-write is taken under this lock
_count_lock = threading.Lock()


def ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    """A tensor's device pointer for a C entry point (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def launch(entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` of the kernel library with ``args``
    and the current stream of ``device`` as its last argument; raise if
    the launch was refused (the entry returns a cudaError_t)."""
    lib = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           f"{lib.kernels_error_string(rc).decode()}")


def count_launch(wrapper, by: Optional[Dict[str, int]] = None,
                 key: Optional[str] = None, n: int = 1) -> None:
    """Add ``n`` (one) to a kernel wrapper's ``launches`` (and to
    ``by[key]``, a count by kernel), under a lock."""
    with _count_lock:
        wrapper.launches += n
        if by is not None:
            by[key] += n
