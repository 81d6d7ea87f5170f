"""Share of decoding in which the device is idle (%): the host-paced part
of a decode step. Decoding is the union, over the decode chunks of the
profiled stretch, of [the chunk's `batcher.dispatch` start, the end of
its `batcher.readback`], less the `batcher.admit` spans and clipped to
the stretch; the idle part is where the trace's device operations show
nothing running."""

from benchmark import spans

UNIT = "%"


def read(r):
    got = spans.placed(r, ("batcher.dispatch", "batcher.readback",
                           "batcher.admit"))
    start, end, admits = {}, {}, []
    for span, s, e in got:
        if span.name == "batcher.admit":
            admits.append((s, e))
        elif span.name == "batcher.dispatch":
            start[span.attrs["chunk"]] = s
        else:
            end[span.attrs["chunk"]] = e
    chunks = [(start[c], end[c]) for c in start if c in end]
    if not chunks:
        return None
    w = r.trace.window_s
    decoding = spans.subtract(spans.clip(chunks, 0.0, w),
                              spans.union(admits))
    total = spans.length(decoding)
    if total <= 0:
        return None
    busy = spans.union((s, e) for _, s, e in r.trace.device_ops)
    idle = spans.length(spans.subtract(decoding, busy))
    return 100.0 * idle / total
