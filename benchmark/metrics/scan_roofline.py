"""The scan kernels' share of their roofline: the least time of the
profiled batches' int8 corpus scan (2QNd at the int8 peak) and bf16
prefix scan (2QNp at the bf16 peak), over those kernels' device time in
the trace (`csrc/fused_scan_int8.cu`, `csrc/fused_scan_bf16.cu`)."""

from benchmark import roofline

UNIT = "%"
PATTERNS = ("scan_int8_kernel", "scan_bf16_kernel")


def read(r):
    if r.trace is None or not r.work.get("traced_batches"):
        return None
    seconds = r.trace.seconds_of(PATTERNS)
    if seconds <= 0:
        return None
    w = r.work
    bound = roofline.scan_bound_s(w["queries"], w["rows"], w["dim"],
                                  w["prefix"]) * w["traced_batches"]
    return 100.0 * bound / seconds
