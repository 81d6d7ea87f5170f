"""In-process priority work queue with retry / failed / success ledger.

Copy of `rag_application_tpu/ingest/queue.py`.

Parity: the reference's RabbitMQ task fabric —
  * priority scheme FILE=255 > STRUCTURED(250-idx) > DIRECT(230-idx) >
    UNSTRUCTURED_PAGE(205-page) (IndexerAPI/src/core/queue/
    rabbitmq_handler.py:66-95),
  * retry queue with TTL cycling back to main, attempt count from
    x-death headers, <=5 attempts then `.failed`, non-retryable errors
    straight to failed (:37-63,157-213; rmq_client.py:29-90),
  * success-queue audit record with processing time (:97-99,215-218),
  * chat > standard strict priority BRPOP (v1, app/core/queue/
    redis_priority_queue.py:30-41).

The TPU framework is single-process around a device, so the fabric is an
asyncio priority queue with the same observable semantics (priorities,
bounded retries, dead-letter ledger, audit log) and no brokers to deploy.
"""

from __future__ import annotations

import asyncio
import enum
import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional


class TaskType(str, enum.Enum):
    FILE = "file"
    URL = "url"
    TEXT = "text"
    UNSTRUCTURED_PAGE = "unstructured_page"
    STRUCTURED_CHUNK = "structured_chunk"
    DIRECT_CHUNK = "direct_chunk"
    AUDIO_CHUNK = "audio_chunk"


class TaskState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCESS = "success"
    RETRYING = "retrying"
    FAILED = "failed"


class NonRetryableError(Exception):
    """Parity: NoSuchKey / EmptyDataError skip the retry cycle
    (rabbitmq_handler.py:37-63)."""


def task_priority(task_type: TaskType, index: int = 0) -> int:
    """Priority 0-255, higher first (parity: _calculate_task_priority,
    rabbitmq_handler.py:66-95)."""
    if task_type == TaskType.FILE:
        return 255
    if task_type == TaskType.STRUCTURED_CHUNK:
        return max(0, 250 - index)
    if task_type == TaskType.DIRECT_CHUNK:
        return max(0, 230 - index)
    if task_type == TaskType.UNSTRUCTURED_PAGE:
        return max(0, 205 - index)
    if task_type == TaskType.AUDIO_CHUNK:
        # same band as unstructured pages (the reference has no audio
        # priorities; its audio processor is a stub)
        return max(0, 205 - index)
    return 128


@dataclass
class Task:
    task_type: TaskType
    payload: Dict[str, Any]
    priority: int = 128
    task_id: str = ""
    attempts: int = 0
    state: TaskState = TaskState.PENDING
    error: Optional[str] = None
    enqueued_at: float = field(default_factory=time.monotonic)


class WorkQueue:
    def __init__(self, *, max_retries: int = 5, max_concurrency: int = 10,
                 max_length: int = 1_000_000):
        self.max_retries = max_retries
        self.max_concurrency = max_concurrency
        self.max_length = max_length  # drop-head bound (rmq x-max-length)
        self._heap: List = []
        self._counter = itertools.count()
        self._cv_obj: Optional[asyncio.Condition] = None
        self._cv_loop = None
        self.failed: List[Task] = []
        self.succeeded: List[Dict[str, Any]] = []  # audit records
        self._inflight = 0
        self._closed = False

    def qsize(self) -> int:
        return len(self._heap)

    @property
    def _cv(self) -> asyncio.Condition:
        """Condition bound to the *current* event loop — the queue outlives
        individual `asyncio.run()` calls (each ingest call runs a loop)."""
        loop = asyncio.get_running_loop()
        if self._cv_obj is None or self._cv_loop is not loop:
            self._cv_obj = asyncio.Condition()
            self._cv_loop = loop
        return self._cv_obj

    async def put(self, task: Task) -> None:
        async with self._cv:
            if len(self._heap) >= self.max_length:
                # bounded queue: evict the lowest-priority, OLDEST entry
                # (heap[0] would be the HIGHEST priority — rmq's
                # drop-head sheds the least-urgent, longest-waiting
                # backlog; maximizing the counter too would churn the
                # NEWEST work out while stale backlog persisted). The
                # shed task lands in the failed ledger so the loss is
                # visible in queue_info, not silent.
                worst = max(range(len(self._heap)),
                            key=lambda i: (self._heap[i][0],
                                           -self._heap[i][1]))
                shed = self._heap[worst][2]
                shed.error = "shed: queue full (drop-head)"
                self.failed.append(shed)
                self._heap[worst] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
            if not task.task_id:
                task.task_id = f"t{next(self._counter)}"
            heapq.heappush(
                self._heap, (-task.priority, next(self._counter), task)
            )
            self._cv.notify()

    async def get(self) -> Optional[Task]:
        async with self._cv:
            while not self._heap and not self._closed:
                await self._cv.wait()
            if not self._heap:
                return None
            _, _, task = heapq.heappop(self._heap)
            return task

    async def close(self) -> None:
        async with self._cv:
            self._closed = True
            self._cv.notify_all()

    async def _process(self, handler, task: Task) -> None:
        task.state = TaskState.RUNNING
        t0 = time.monotonic()
        try:
            await handler(task)
        except NonRetryableError as e:
            task.state = TaskState.FAILED
            task.error = str(e)
            self.failed.append(task)
        except Exception as e:  # noqa: BLE001 — the retry cycle
            task.attempts += 1
            task.error = str(e)
            if task.attempts >= self.max_retries:
                task.state = TaskState.FAILED
                self.failed.append(task)
            else:
                task.state = TaskState.RETRYING
                await self.put(task)
        else:
            task.state = TaskState.SUCCESS
            self.succeeded.append({
                "task_id": task.task_id,
                "task_type": task.task_type.value,
                "processing_time_seconds": time.monotonic() - t0,
                "attempts": task.attempts,
            })

    async def run(
        self,
        handler: Callable[[Task], Awaitable[Any]],
        *,
        drain: bool = True,
    ) -> None:
        """Consume tasks with a pool of `max_concurrency` workers until the
        queue drains (`drain=True`, counting retries) or `close()` is
        called. Workers pop strictly by priority."""

        async def worker() -> None:
            while True:
                async with self._cv:
                    while not self._heap:
                        if self._closed or (drain and self._inflight == 0):
                            return
                        await self._cv.wait()
                    _, _, task = heapq.heappop(self._heap)
                    self._inflight += 1
                try:
                    await self._process(handler, task)
                finally:
                    async with self._cv:
                        self._inflight -= 1
                        self._cv.notify_all()

        await asyncio.gather(*(worker() for _ in range(self.max_concurrency)))

    def queue_info(self) -> Dict[str, Any]:
        """Parity: get_queue_info introspection (rabbitmq_handler.py:248-262)."""
        return {
            "pending": self.qsize(),
            "failed": len(self.failed),
            "succeeded": len(self.succeeded),
        }
