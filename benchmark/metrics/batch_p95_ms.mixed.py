"""95th percentile of the batch time, from dispatch to ids on the host,
over every batch of the traced run's window (host clock)."""

from benchmark import harness

UNIT = "ms"


def read(r):
    spans = r.spans.get("batch")
    if not spans:
        return None
    return 1e3 * harness.percentile(spans, 95)
