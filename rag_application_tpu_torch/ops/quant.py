"""Quantization + matryoshka-view ops.

Port of `rag_application_tpu/ops/quant.py:30-63,137-150`: symmetric int8
quantization `clip(round(x*127), -127, 127)` (round half to even, as
`jnp.round`) and the per-row inverse prefix norms that turn matryoshka
prefix inner products into cosines. The insert-time Pallas kernel
`_prep_kernel` is not on the query path and is not ported yet; the index
uses the plain twin `prepare_vectors_xla`, as the JAX `DenseIndex` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


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
