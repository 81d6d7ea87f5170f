from .runtime import DeviceLike, cdiv, full_f32_matmul, resolve_device, round_up
from .observability import METRICS, Metrics, device_trace

__all__ = [
    "DeviceLike",
    "cdiv",
    "full_f32_matmul",
    "resolve_device",
    "round_up",
    "METRICS",
    "Metrics",
    "device_trace",
]
