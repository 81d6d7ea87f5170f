"""The decode-attention kernel's share of its roofline
(`csrc/decode_attn.cu`: split, then combine): the bytes a call needs
(int8 K and V and their scales of each visible slot, the mask, q and
out, counted from the context of each request live in the profiled
stretch) at the HBM bandwidth, over the kernel's device time a call."""

from benchmark import roofline

UNIT = "%"
PATTERNS = ("decode_attn_split", "decode_attn_combine")


def read(r):
    if r.trace is None or not r.work.get("live_context"):
        return None
    calls = len(r.trace.matching(PATTERNS[:1]))
    seconds = r.trace.seconds_of(PATTERNS)
    if not calls or seconds <= 0:
        return None
    w = r.work
    nbytes = roofline.decode_attn_bytes(w["live_context"], w["kv_heads"],
                                        w["groups"], w["head_dim"])
    return 100.0 * calls * (nbytes / roofline.HBM_BYTES_S) / seconds
