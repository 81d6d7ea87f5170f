"""Share of the profiled stretch of a generation window spent admitting
requests (%): the union of the continuous batcher's `batcher.admit`
spans (`ContinuousBatcher._admit`: a request's prefill pasted into its
row), clipped to the stretch. No row decodes meanwhile. A stretch whose
batcher spans hold no admission reads 0."""

from benchmark import spans

UNIT = "%"


def read(r):
    got = spans.placed(r, ("batcher.admit", "batcher.dispatch",
                           "batcher.readback", "batcher.deliver"))
    if not got:
        return None
    w = r.trace.window_s
    covered = spans.clip(((s, e) for span, s, e in got
                          if span.name == "batcher.admit"), 0.0, w)
    return 100.0 * spans.length(covered) / w
