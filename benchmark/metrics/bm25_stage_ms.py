"""Device time of the funnel's BM25 stage a search batch (ms): the CUDA
events of the program's `search.bm25` span around `fused_core`'s call of
`ops/bm25.py::bm25_topk` (the candidate pool, its sort and the match
kernel), averaged over the batches of the profiled stretch."""

from benchmark import spans

UNIT = "ms"


def read(r):
    return spans.per_batch_ms(r, "search.bm25", device=True)
