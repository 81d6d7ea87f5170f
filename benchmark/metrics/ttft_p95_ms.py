"""95th percentile of the time to first token over every request sent in
the traced run's window, from `submit_stream` to the first token (host
clock; the wait for admission included). A request with no first token
when the window closes counts the time from its submit to the close."""

from benchmark import harness

UNIT = "ms"


def read(r):
    spans = r.spans.get("ttft")
    if not spans:
        return None
    return 1e3 * harness.percentile(spans, 95)
