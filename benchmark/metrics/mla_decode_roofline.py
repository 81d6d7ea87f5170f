"""The absorbed decode attention's share of its roofline: over the
`model.mla` spans of decode steps in the profiled stretch (the program's
spans around W_uk's absorption, the decode kernel and W_uv, with their
CUDA events' device time, the step's rows and the latents they see),
the least time the chip could take for their work
(`roofline_moe.mla_decode_work`: each visible latent read once, W_uk and
W_uv, q and out; the larger of operations at the bf16 peak and bytes at
the HBM bandwidth, call by call) over their device time. The kernel
reads each latent twice, as key and as value."""

from benchmark import roofline_moe, spans

UNIT = "%"


def read(r):
    w = r.work.get("deepseek")
    if not w or r.trace is None:
        return None
    bound = seconds = 0.0
    for span, s, e in spans.placed(r, ("model.mla",)):
        slots = span.attrs.get("slots")
        if span.attrs.get("path") != "decode" or span.end_ns is None \
                or s < 0.0 or e > r.trace.window_s or slots is None:
            continue
        ms = span.device_ms
        if ms is None:
            continue
        bound += roofline_moe.bound_s(
            roofline_moe.mla_decode_work(w, span.attrs["tokens"],
                                         int(slots)),
            roofline_moe.PEAK_BF16_FLOPS)
        seconds += ms / 1e3
    if seconds <= 0.0:
        return None
    return 100.0 * bound / seconds
