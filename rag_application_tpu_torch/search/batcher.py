"""Request micro-batching: make engine-batch throughput reachable
through the per-request HTTP API.

Copy of `rag_application_tpu/search/batcher.py` (asyncio and numpy only).

The fused funnel's throughput comes from large query batches (the scan
reads the whole corpus once a batch, whatever its size), but HTTP
requests arrive one query at a time. The
reference leans on Qdrant's internal batching; here the serving layer
owns it: concurrent requests enqueue into a per-collection
`MicroBatcher`, a worker drains the queue every `max_wait_ms` (or at
`max_batch`), pads the group to a power-of-two query count (funnel
variants are compiled per batch-size bucket — search/params.py
convention) and runs ONE `hybrid_search_batch` for the whole group in
an executor, keeping the event loop free.

Latency cost is bounded by `max_wait_ms` (default 2 ms); a lone request
still runs immediately after one drain tick.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Callable, List, Optional


def _bucket(n: int, lo: int = 1, hi: int = 2048) -> int:
    """Next power of two in [lo, hi]."""
    b = lo
    while b < n and b < hi:
        b <<= 1
    return b


@dataclass
class _Pending:
    embedding: Any          # (d,) np array
    text: Optional[str]
    limit: int
    future: asyncio.Future


class MicroBatcher:
    """Batches `search(embedding, text, limit)` calls onto one engine
    dispatch. `run_batch(embs, texts, limit) -> List[List[hit]]` is the
    synchronous engine call (Collection.hybrid_search_batch). When every
    submission passes `embedding=None`, run_batch receives embs=None and
    encodes the texts itself — so the encoder forward batches too (the
    per-request encode otherwise serializes on the event loop)."""

    def __init__(self, run_batch: Callable[..., List[List[Any]]], *,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 max_inflight: int = 2):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # groups processed concurrently: 2 pipelines the next group's
        # assembly + encode + upload under the previous group's engine
        # dispatch and host-side hit materialization (the device itself
        # serializes; the overlap hides host/transfer time)
        self.max_inflight = max(1, max_inflight)
        self._queue: "asyncio.Queue[_Pending]" = asyncio.Queue()
        self._worker: Optional[asyncio.Task] = None
        self.batches_run = 0
        self.requests_served = 0

    async def search(self, embedding, text: Optional[str],
                     limit: int) -> List[Any]:
        if self._worker is None or self._worker.done():
            self._worker = asyncio.ensure_future(self._run())
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put(_Pending(embedding, text, limit, fut))
        return await fut

    async def _run(self) -> None:
        sem = asyncio.Semaphore(self.max_inflight)
        while True:
            first = await self._queue.get()
            await asyncio.sleep(self.max_wait_s)  # collect a window
            group: List[_Pending] = [first]
            while not self._queue.empty() and len(group) < self.max_batch:
                group.append(self._queue.get_nowait())
            # a window can mix precomputed-embedding and embedding=None
            # submissions; np.stack cannot serve both in one batch, so
            # they PARTITION into sub-groups instead of poisoning each
            # other with a ValueError
            parts = [[p for p in group if p.embedding is None],
                     [p for p in group if p.embedding is not None]]
            for part in parts:
                if not part:
                    continue
                # up to max_inflight groups process concurrently
                # (pipelining); the semaphore backpressures assembly
                await sem.acquire()
                asyncio.ensure_future(self._process(part, sem))

    async def _process(self, group: List[_Pending],
                       sem: asyncio.Semaphore) -> None:
        import numpy as np

        loop = asyncio.get_running_loop()
        try:
            # group assembly is inside the try: a mixed group (some
            # embedding=None, some ndarray) makes np.stack raise, and
            # an escape here would kill the worker with every future
            # unresolved — hanging those HTTP requests forever
            embs = [p.embedding for p in group]
            texts = ([p.text for p in group]
                     if any(p.text is not None for p in group) else None)
            if texts is not None:
                texts = [t if t is not None else "" for t in texts]
            limit = max(p.limit for p in group)
            # pad the query axis to its bucket so repeated batch sizes
            # reuse the compiled funnel variant
            b = _bucket(len(group))
            if b > len(group):
                embs = embs + [embs[0]] * (b - len(group))
                if texts is not None:
                    texts = texts + [texts[0]] * (b - len(group))
            stacked = (None if all(e is None for e in embs)
                       else np.stack(embs))
            results = await loop.run_in_executor(
                None, lambda: self.run_batch(stacked, texts, limit))
            self.batches_run += 1
            for p, hits in zip(group, results):
                if not p.future.done():
                    p.future.set_result(hits[: p.limit])
            self.requests_served += len(group)
        except Exception as e:  # noqa: BLE001
            for p in group:
                if not p.future.done():
                    p.future.set_exception(e)
        finally:
            sem.release()
