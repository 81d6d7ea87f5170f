"""Shared pieces of the benchmark's tests: tiny copies of each cell that
run on the CPU through the same drivers, and the `card` marker.

Tests marked `card` need a CUDA device and skip without one; whether
there is one is decided inside the `card` fixture, never at import.
Run them on the card with `python3 -m pytest benchmark/tests -m card`.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402

SEED = 2 ** 31 + 123_457  # past 32 signed bits, as the driver's are


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_search(name: str) -> harness.Cell:
    """A search cell at a size the CPU runs in seconds: same widths,
    fewer rows and queries."""
    cell = harness.find_cell(name)
    cell.config = dict(cell.config, rows=8192)
    cell.mix = dict(cell.mix, batch=128, pool_batches=2, sample=96,
                    trace_batches=2, control_batches=2)
    return cell


def tiny_generate() -> harness.Cell:
    """The generation cell with a two-layer model of the same kinds
    (GQA, head_dim 64 so the decode-attention branch is taken) and four
    clients."""
    cell = harness.find_cell("mistral-7b-v0.2.rag-answers-32")
    cell.config = dict(cell.config, hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=64, vocab_size=1000)
    cell.mix = dict(cell.mix, clients=4, per_client=4, system_tokens=16,
                    context_tokens=[32, 96], question_tokens=[4, 8],
                    new_tokens=[8, 16], judged_requests=3,
                    batcher={"slots": 4, "prompt_pad": 128, "horizon": 256,
                             "chunk": 4}, trace_seconds=0.5)
    return cell
