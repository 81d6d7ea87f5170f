"""Evaluation harnesses (real-document retrieval/answer quality).

Port of `rag_application_tpu/evals/__init__.py`."""

from .real_docs import (  # noqa: F401
    QUESTIONS,
    build_real_docs_stack,
    evaluate_real_docs,
    extractive_answer,
)
