"""A request's wait in the continuous batcher's queue (ms): the median
`batcher.queue` span (from `submit_stream`'s put to the start of the
request's admission) of the requests admitted in the profiled stretch.
If none was admitted there: those still queued at its close, counted to
the close; if no request waited, 0."""

import statistics

from benchmark import spans

UNIT = "ms"


def read(r):
    got = spans.placed(r, ("batcher.queue", "batcher.admit",
                           "batcher.dispatch", "batcher.deliver"))
    if not got:
        return None
    w = r.trace.window_s
    queue = [(span, s, e) for span, s, e in got
             if span.name == "batcher.queue"]
    admitted = [e - s for span, s, e in queue
                if span.end_ns is not None and 0.0 <= e <= w]
    if admitted:
        return 1e3 * statistics.median(admitted)
    waiting = [w - s for span, s, e in queue
               if span.end_ns is None or e > w]
    return 1e3 * statistics.median(waiting) if waiting else 0.0
