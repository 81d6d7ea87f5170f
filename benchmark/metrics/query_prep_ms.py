"""Host time of the search entry's query preparation (`FusedSearcher.
prepare`: the BM25 query encode and the upload), ms a batch: the mean of
the harness's spans around `prepare` over the traced run's window."""

UNIT = "ms"


def read(r):
    spans = r.spans.get("prepare")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
