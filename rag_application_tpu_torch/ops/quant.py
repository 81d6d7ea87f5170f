"""Quantization + matryoshka-view ops.

Port of `rag_application_tpu/ops/quant.py:30-63,137-150`: symmetric int8
quantization `clip(round(x*127), -127, 127)` (round half to even, as
`jnp.round`) and the per-row inverse prefix norms that turn matryoshka
prefix inner products into cosines.

`prepare_vectors` is the kernel wrapper of the insert-time pass: on CUDA
tensors it launches `csrc/prep_vectors.cu` (the port of the Pallas
`_prep_kernel`), on CPU tensors it runs `prepare_vectors_plain`, which is
`prepare_vectors_xla` under a second name (the JAX name is kept).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..kernels import launch, ptr


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of unit-norm vectors (clip(round(x*127)))."""
    scaled = torch.round(x.float() * 127.0)
    return torch.clamp(scaled, -127, 127).to(torch.int8)


def dequantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (up to rounding)."""
    return x.float() / 127.0


def matryoshka_inv_norms(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """(N, d) row-normalized vectors -> (N, len(dims)) f32 inverse L2 norms
    of each prefix view; column j scales `q[:dims_j] . x[:dims_j]` into a
    cosine."""
    if not dims:
        return torch.zeros((x.shape[0], 0), dtype=torch.float32,
                           device=x.device)
    sq = x.float() * x.float()
    cols = [torch.rsqrt(torch.clamp(sq[:, :d].sum(dim=-1), min=1e-12))
            for d in dims]
    return torch.stack(cols, dim=-1)


def prepare_vectors_xla(
    x: torch.Tensor, dims: Sequence[int], *, out_dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize + int8 + prefix norms of an insert batch:
    (normalized (N, d) out_dtype, int8 (N, d), inv_norms (N, len(dims)) f32).
    Keeps the JAX name of the plain twin of `prepare_vectors`."""
    xf = x.float()
    inv_full = torch.rsqrt(
        torch.clamp((xf * xf).sum(dim=-1, keepdim=True), min=1e-12))
    xn = xf * inv_full
    return xn.to(out_dtype), quantize_int8(xn), matryoshka_inv_norms(xn, dims)


prepare_vectors_plain = prepare_vectors_xla

MAX_PREP_DIMS = 64  # prep_vectors_launch's limit


def prepare_vectors(
    x: torch.Tensor, dims: Sequence[int], *, out_dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over an insert batch: normalize + int8 + prefix norms,
    (normalized (N, d) out_dtype, int8 (N, d), inv_norms (N, len(dims))
    f32).

    Kernel wrapper: launches `csrc/prep_vectors.cu` for a CUDA tensor and
    runs `prepare_vectors_plain` for a CPU tensor. Half-width inputs are
    upcast to f32 first, as the reference's kernel does. The kernel
    writes the bf16 plane the index stores; another ``out_dtype`` runs
    only on the CPU."""
    if x.device.type == "cpu":
        return prepare_vectors_plain(x, dims, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"prepare_vectors: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"prepare_vectors: (N, d) input needed, got "
                         f"{tuple(x.shape)}")
    dims = tuple(int(v) for v in dims)
    if len(dims) > MAX_PREP_DIMS:
        raise ValueError(f"prepare_vectors: at most {MAX_PREP_DIMS} "
                         f"matryoshka dims, got {len(dims)}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"prepare_vectors: the kernel writes bf16, not "
                        f"{out_dtype}")
    xf = x.float().contiguous()
    n, d = xf.shape
    norm = torch.empty((n, d), dtype=torch.bfloat16, device=x.device)
    i8 = torch.empty((n, d), dtype=torch.int8, device=x.device)
    inv = torch.empty((n, len(dims)), dtype=torch.float32, device=x.device)
    if n == 0:
        return norm, i8, inv
    arr = (ctypes.c_int * max(len(dims), 1))(*dims)
    launch("prep_vectors_launch", x.device, ptr(xf), n, d,
           ctypes.cast(arr, ctypes.c_void_p), len(dims), ptr(norm), ptr(i8),
           ptr(inv) if dims else None)
    prepare_vectors.launches += 1
    return norm, i8, inv


prepare_vectors.launches = 0
