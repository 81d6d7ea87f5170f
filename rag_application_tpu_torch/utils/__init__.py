from .runtime import DeviceLike, cdiv, full_f32_matmul, resolve_device, round_up
from .observability import METRICS, TRACER, Metrics

__all__ = [
    "DeviceLike",
    "cdiv",
    "full_f32_matmul",
    "resolve_device",
    "round_up",
    "METRICS",
    "Metrics",
    "TRACER",
]
