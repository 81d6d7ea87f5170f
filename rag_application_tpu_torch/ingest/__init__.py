from .chunker import chunk_text, chunk_words
from .queue import WorkQueue, Task, TaskType, TaskState
from .pipeline import IngestPipeline

__all__ = [
    "chunk_text",
    "chunk_words",
    "WorkQueue",
    "Task",
    "TaskType",
    "TaskState",
    "IngestPipeline",
]
