"""Device time of the funnel's matryoshka cascade a search batch (ms):
the CUDA events of the program's `search.cascade` span (the bf16 prefix
scan, the prefix rescores and the exact rescore, with their sorts),
averaged over the batches of the profiled stretch."""

from benchmark import spans

UNIT = "ms"


def read(r):
    return spans.per_batch_ms(r, "search.cascade", device=True)
