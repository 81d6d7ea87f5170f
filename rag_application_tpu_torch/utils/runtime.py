"""Runtime helpers shared by kernels and index code.

Port of `rag_application_tpu/utils/runtime.py`. `resolve_device` replaces
`use_interpret`/`on_tpu`: the port runs on CUDA by default and takes the
CPU only when the caller asks for it (the tests do); there is no silent
CPU fallback.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """Run float32 products in full float32 on the card (TF32 off) —
    the precision the JAX package asks for with
    ``preferred_element_type=float32``. Restores the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
