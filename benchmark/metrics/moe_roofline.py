"""The expert layers' share of their roofline: over the `model.moe` spans
of the profiled stretch (the program's spans, each a layer's call, with
its CUDA events' device time, its tokens and the distinct routed experts
it reached), the least time the chip could take for their work
(`roofline_moe.moe_work`: the larger of operations at the bf16 peak and
bytes at the HBM bandwidth, call by call) over their device time."""

from benchmark import roofline_moe, spans

UNIT = "%"


def read(r):
    w = r.work.get("deepseek")
    if not w or r.trace is None:
        return None
    bound = seconds = 0.0
    for span, s, e in spans.placed(r, ("model.moe",)):
        hit = span.attrs.get("experts")
        if span.end_ns is None or s < 0.0 or e > r.trace.window_s \
                or hit is None:
            continue
        ms = span.device_ms
        if ms is None:
            continue
        bound += roofline_moe.bound_s(
            roofline_moe.moe_work(w, span.attrs["tokens"], int(hit)),
            roofline_moe.PEAK_BF16_FLOPS)
        seconds += ms / 1e3
    if seconds <= 0.0:
        return None
    return 100.0 * bound / seconds
