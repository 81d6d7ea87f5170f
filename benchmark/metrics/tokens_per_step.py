"""Tokens delivered a decode step over the window: the continuous
batcher's own counters (`stats()`: tokens_out over steps)."""

UNIT = "tokens/step"


def read(r):
    steps = r.counters.get("steps")
    if not steps:
        return None
    return r.counters["tokens_out"] / steps
