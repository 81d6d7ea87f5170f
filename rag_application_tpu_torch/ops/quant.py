"""Quantization + matryoshka-view ops.

Port of `rag_application_tpu/ops/quant.py:30-63,137-150`: symmetric int8
quantization `clip(round(x*127), -127, 127)` (round half to even, as
`jnp.round`) and the per-row inverse prefix norms that turn matryoshka
prefix inner products into cosines.

`prepare_vectors_into` and `prepare_vectors` are the wrappers of the
insert-time pass, `csrc/prep_vectors.cu` (the port of the Pallas
`_prep_kernel`): the first writes rows of a dense index's own planes in
place (`DenseIndex.insert`), the second three new tensors. On CPU tensors
each runs its plain version; `prepare_vectors_plain` is
`prepare_vectors_xla` under a second name (the JAX name is kept). The
plain version adds its sums in the kernel's order and takes 1 / sqrt in
f64, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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


def _lane_sum(sq: torch.Tensor) -> torch.Tensor:
    """(N, d) f32 -> (N,) row sums in the prep kernel's order: element c
    is added by lane (c // 4) % 32 in increasing c, then the 32 lane sums
    add by halves. Each step is one f32 add, so the kernel's shuffles give
    the same bits."""
    n, d = sq.shape
    chunks = -(-d // 128)
    v = torch.zeros((n, chunks * 128), dtype=torch.float32, device=sq.device)
    v[:, :d] = sq
    v = v.view(n, chunks, 32, 4)
    acc = torch.zeros((n, 32), dtype=torch.float32, device=sq.device)
    for k in range(chunks):
        for t in range(4):
            acc = acc + v[:, k, :, t]
    w = 32
    while w > 1:
        w //= 2
        acc = acc[:, :w] + acc[:, w:2 * w]
    return acc[:, 0]


def _inv_norm(s: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(max(s, 1e-12)) in f64, rounded once to f32 (the reference's
    rsqrt; both steps correctly rounded, on any device)."""
    return torch.reciprocal(
        torch.sqrt(torch.clamp(s, min=1e-12).double())).float()


def prepare_vectors_xla(
    x: torch.Tensor, dims: Sequence[int], *, out_dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize + int8 + prefix norms of an insert batch:
    (normalized (N, d) out_dtype, int8 (N, d), inv_norms (N, len(dims)) f32).
    Keeps the JAX name of the plain twin of `prepare_vectors`; sums add in
    the kernel's order (`_lane_sum`)."""
    xf = x.float()
    xn = xf * _inv_norm(_lane_sum(xf * xf))[:, None]
    sq = xn * xn
    inv = [_inv_norm(_lane_sum(sq[:, :d])) for d in dims]
    inv = (torch.stack(inv, dim=-1) if inv else
           torch.zeros((xf.shape[0], 0), dtype=torch.float32,
                       device=x.device))
    return xn.to(out_dtype), quantize_int8(xn), inv


prepare_vectors_plain = prepare_vectors_xla

MAX_PREP_DIMS = 64  # prep_vectors_launch's limit


def _prep_rows(name: str, x: torch.Tensor,
               dims: Sequence[int]) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """The kernel's f32 (N, d) input and dims, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name}: (N, d) input needed, got "
                         f"{tuple(x.shape)}")
    dims = tuple(int(v) for v in dims)
    if len(dims) > MAX_PREP_DIMS:
        raise ValueError(f"{name}: at most {MAX_PREP_DIMS} matryoshka dims, "
                         f"got {len(dims)}")
    return x.float().contiguous(), dims


def _launch_prep(xf: torch.Tensor, dims: Tuple[int, ...], norm, i8, inv,
                 live) -> None:
    """One launch of csrc/prep_vectors.cu over the rows of ``xf``; each
    output is the plane's first row to write, or None."""
    n, d = xf.shape
    arr = (ctypes.c_int * max(len(dims), 1))(*dims)
    launch("prep_vectors_launch", xf.device, ptr(xf), n, d,
           ctypes.cast(arr, ctypes.c_void_p), len(dims), ptr(norm), ptr(i8),
           ptr(inv) if dims else None, ptr(live))


def prepare_vectors(
    x: torch.Tensor, dims: Sequence[int], *, out_dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over an insert batch: normalize + int8 + prefix norms,
    (normalized (N, d) out_dtype, int8 (N, d), inv_norms (N, len(dims))
    f32).

    Kernel wrapper: launches `csrc/prep_vectors.cu` into new tensors for
    a CUDA tensor and runs `prepare_vectors_plain` for a CPU tensor.
    Half-width inputs are upcast to f32 first, as the reference's kernel
    does. The kernel writes the bf16 plane the index stores; another
    ``out_dtype`` runs only on the CPU."""
    if x.device.type == "cpu":
        return prepare_vectors_plain(x, dims, out_dtype=out_dtype)
    xf, dims = _prep_rows("prepare_vectors", x, dims)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"prepare_vectors: the kernel writes bf16, not "
                        f"{out_dtype}")
    n, d = xf.shape
    norm = torch.empty((n, d), dtype=torch.bfloat16, device=x.device)
    i8 = torch.empty((n, d), dtype=torch.int8, device=x.device)
    inv = torch.empty((n, len(dims)), dtype=torch.float32, device=x.device)
    if n == 0:
        return norm, i8, inv
    _launch_prep(xf, dims, norm, i8, inv, None)
    prepare_vectors.launches += 1
    return norm, i8, inv


prepare_vectors.launches = 0


def prepare_vectors_into_plain(x: torch.Tensor, dims: Sequence[int],
                               vecs: Optional[torch.Tensor],
                               int8: Optional[torch.Tensor],
                               inv_norms: torch.Tensor, live: torch.Tensor,
                               start: int) -> None:
    """Plain version of `prepare_vectors_into`: `prepare_vectors_plain`,
    then its outputs copied into rows [start, start + N)."""
    norm, i8, inv = prepare_vectors_plain(x, dims)
    end = start + x.shape[0]
    if vecs is not None:
        vecs[start:end] = norm
    if int8 is not None:
        int8[start:end] = i8
    inv_norms[start:end] = inv
    live[start:end] = True


def prepare_vectors_into(x: torch.Tensor, dims: Sequence[int],
                         vecs: Optional[torch.Tensor],
                         int8: Optional[torch.Tensor],
                         inv_norms: torch.Tensor, live: torch.Tensor,
                         start: int) -> None:
    """The insert pass written in place: rows [start, start + N) of the
    index's planes get the normalized bf16 rows (``vecs``), their int8
    (``int8``; either may be None: not stored) and the inverse prefix
    norms (``inv_norms``, (cap, len(dims)) f32), and are set in ``live``
    ((cap,) bool). Rows outside that range are not touched.

    Kernel wrapper: one launch of `csrc/prep_vectors.cu` for a CUDA
    tensor, `prepare_vectors_into_plain` for a CPU tensor."""
    if x.device.type == "cpu":
        prepare_vectors_into_plain(x, dims, vecs, int8, inv_norms, live,
                                   start)
        return
    xf, dims = _prep_rows("prepare_vectors_into", x, dims)
    n, d = xf.shape
    end = start + n
    planes = (("vecs", vecs, torch.bfloat16, (d,)),
              ("int8", int8, torch.int8, (d,)),
              ("inv_norms", inv_norms, torch.float32, (len(dims),)),
              ("live", live, torch.bool, ()))
    for name, t, dtype, width in planes:
        if t is None and name in ("vecs", "int8"):
            continue
        if t.dtype != dtype or tuple(t.shape[1:]) != width \
                or not t.is_contiguous() or t.device != xf.device:
            raise ValueError(f"prepare_vectors_into: {name} must be a "
                             f"contiguous {dtype} tensor of shape (cap,) + "
                             f"{width} on {xf.device}")
        if not 0 <= start <= end <= t.shape[0]:
            raise ValueError(f"prepare_vectors_into: rows [{start}, {end}) "
                             f"out of {name}'s {t.shape[0]}")
    if n == 0:
        return
    _launch_prep(xf, dims, None if vecs is None else vecs[start:],
                 None if int8 is None else int8[start:], inv_norms[start:],
                 live[start:])
    prepare_vectors_into.launches += 1


prepare_vectors_into.launches = 0
