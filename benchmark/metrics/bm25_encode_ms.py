"""Host time of the BM25 query encode a search batch (ms): the program's
`search.encode` span (`index/sparse.py::SparseIndex.encode_queries`: the
per-query loop and its copies to the card), summed a batch and averaged
over the batches of the profiled stretch."""

from benchmark import spans

UNIT = "ms"


def read(r):
    return spans.per_batch_ms(r, "search.encode", device=False)
