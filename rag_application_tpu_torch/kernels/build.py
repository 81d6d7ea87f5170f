"""Build the port's CUDA kernels into one shared library, loaded via ctypes.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a` (Hopper; the `a` keeps wgmma/setmaxnreg
available), then linked into `build/torch_kernels/libtorch_kernels.so`
next to the package. The sources carry a plain C interface (pointers and
the stream as `void*`, each entry returning a `cudaError_t`), so no
PyTorch header is compiled and a build takes seconds. The library is
rebuilt when a hash of the sources and flags changes, recorded in a
sidecar stamp as `native/__init__.py` does for the C analyzer; the
compiler's output (including `-Xptxas -v` register and spill counts)
is kept in `build.log` beside it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB = os.path.join(BUILD_DIR, "libtorch_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def _digest(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build(force: bool = False) -> str:
    """Compile csrc/*.cu (one nvcc each, in parallel) and link the
    library if the sources changed; returns its path."""
    srcs = sources()
    stamp = LIB + ".sha256"
    with _lock:
        digest = _digest(srcs)
        current = None
        if os.path.exists(stamp):
            with open(stamp) as f:
                current = f.read().strip()
        if not force and os.path.exists(LIB) and current == digest:
            return LIB
        os.makedirs(BUILD_DIR, exist_ok=True)
        exe = nvcc()
        tag = f"{os.getpid()}"
        objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
                for s in srcs]
        procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-c", s, "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs, failed = [], []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(s)}\n{out}")
            if p.returncode:
                failed.append(os.path.basename(s))
        tmp = f"{LIB}.{tag}.tmp"
        if not failed:
            link = subprocess.run([exe, *ARCH, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode:
                failed.append("link")
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        log = "\n".join(logs)
        with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
            f.write(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        os.replace(tmp, LIB)
        with open(f"{stamp}.{tag}.tmp", "w") as f:
            f.write(digest)
        os.replace(f"{stamp}.{tag}.tmp", stamp)
    return LIB


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, declaring signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_scan_launch.restype = i
    lib.fused_scan_launch.argtypes = [p, i, ll, p, i, i, p, p, ll,
                                      i, i, i, i, p, p, p]
    lib.bm25_match_launch.restype = i
    lib.bm25_match_launch.argtypes = [p, ll, p, ll, p, ll, i, i, i, p, p, i,
                                      p, p]
    lib.decode_attn_launch.restype = i
    lib.decode_attn_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       ctypes.c_float, p, p, p]
    lib.moe_experts_launch.restype = i
    lib.moe_experts_launch.argtypes = [p, ll, p, ll, i, p, i, i, i, i, p, p,
                                       p, p, p, p, p, p, p]
    lib.prep_vectors_launch.restype = i
    lib.prep_vectors_launch.argtypes = [p, ll, i, p, i, p, p, p, p, p]
    lib.kernels_error_string.restype = ctypes.c_char_p
    lib.kernels_error_string.argtypes = [i]
    _lib = lib
    return lib
