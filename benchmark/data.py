"""Seeded inputs of every cell: corpora, queries, token documents,
request mixes and decoder weights.

Everything here is a function of ``--seed`` alone, so the program and the
plain reference (benchmark/reference/) are handed the same inputs, and
the reference can make them again after the window. The zipf token
generator and the noisy query texts follow chip_smoke.py's
(`zipf_probs`, `synth_tokens`, `noisy_texts`); the corpus rows are its
spectrally decaying gaussians.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

SLAB = 131072  # corpus rows drawn per generator call


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed`` (any whole
    number, also past 32 bits)."""
    state = np.random.SeedSequence([int(seed) & ((1 << 64) - 1),
                                    int(tag)]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def torch_gen(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# ----------------------------------------------------------------- search


def zipf_probs(n: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def synth_tokens(seed: int, n: int, vocab: int, doc_len: int) -> np.ndarray:
    """(n, doc_len) int32 zipfian bag-of-words documents."""
    cdf = np.cumsum(zipf_probs(vocab))
    cdf[-1] = 1.0
    u = rng(seed, 4).random((n, doc_len))
    return np.searchsorted(cdf, u, side="right").astype(np.int32)


def noisy_tokens(tokens: np.ndarray, idx: np.ndarray, seed: int,
                 flip: float, vocab: int) -> np.ndarray:
    """The documents ``idx`` with ~``flip`` of their words resampled
    uniformly over the vocabulary."""
    r = rng(seed, 5)
    t = tokens[idx].copy()
    hit = r.random(t.shape) < flip
    t[hit] = r.integers(0, vocab, int(hit.sum()))
    return t


def texts(rows: np.ndarray) -> List[str]:
    """Token rows as the texts a client sends ("w17 w3 ...")."""
    return [" ".join(f"w{w}" for w in row) for row in rows.tolist()]


def corpus_slabs(seed: int, n: int, d: int, rate: float,
                 device) -> Iterator[Tuple[int, torch.Tensor]]:
    """The corpus as (start, rows) slabs of f32 spectrally decaying
    gaussian rows, drawn on ``device`` in SLAB-row calls."""
    gen = torch_gen(seed, 1, device)
    scale = torch.exp(-rate * torch.arange(d, dtype=torch.float32,
                                           device=device))
    for s in range(0, n, SLAB):
        x = torch.randn((min(SLAB, n - s), d), generator=gen,
                        device=device)
        yield s, x.mul_(scale)


def query_sources(seed: int, n: int, count: int) -> np.ndarray:
    """The corpus rows the query pool is made from."""
    return rng(seed, 2).integers(0, n, size=count)


def query_pool(seed: int, rows: torch.Tensor, noise: float) -> np.ndarray:
    """Queries: the normalized source rows plus gaussian noise, on the
    host as f32 (what a client uploads)."""
    q = rows / torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    gen = torch_gen(seed, 3, rows.device)
    q = q + noise * torch.randn(q.shape, generator=gen, device=rows.device)
    return q.cpu().numpy().astype(np.float32)


# ------------------------------------------------------------- generation


def request_mix(seed: int, clients: int, per_client: int,
                mix: Dict) -> List[List[Dict[str, int]]]:
    """Each client's sequence of requests: (context, question, new)
    token counts. Requests come in rounds, one pair a client each: a
    round's pairs are the same for every seed, their sizes spread evenly
    over the mix's ranges, and the two requests of a pair add up to the
    ends of the ranges, so any two consecutive requests of a client carry
    the same work. The seed only deals each round's pairs out to the
    clients in another order."""
    lo_c, hi_c = mix["context_tokens"]
    lo_q, hi_q = mix["question_tokens"]
    lo_n, hi_n = mix["new_tokens"]

    def spread(lo: int, hi: int, r: np.random.Generator) -> np.ndarray:
        # one value in each of `clients` equal slices of [lo, hi], the
        # slices in a fixed order of their own
        steps = (np.arange(clients) + 0.5) / clients
        return np.rint(lo + (hi - lo) * steps[r.permutation(clients)]
                       ).astype(int)

    base = np.random.default_rng(0)
    deal = rng(seed, 10)
    out: List[List[Dict[str, int]]] = [[] for _ in range(clients)]
    for _ in range(per_client // 2):
        c, q, n = (spread(*rg, base) for rg in
                   ((lo_c, hi_c), (lo_q, hi_q), (lo_n, hi_n)))
        for client, p in enumerate(deal.permutation(clients)):
            out[client].append({"context": int(c[p]), "question": int(q[p]),
                                "new": int(n[p])})
            out[client].append({"context": int(lo_c + hi_c - c[p]),
                                "question": int(lo_q + hi_q - q[p]),
                                "new": int(lo_n + hi_n - n[p])})
    return out


def prompt_tokens(seed: int, tag: int, count: int, vocab: int) -> List[int]:
    """``count`` token ids, never the three special ids 0-2."""
    return rng(seed, tag).integers(3, vocab, count).tolist()


DECODER_LEAVES = ("tok_emb", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                  "w_down", "lm_head")


def decoder_shapes(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """Each random leaf of the decoder in the port's stacked (in, out)
    layout, with its fan-in."""
    L, H, M = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["intermediate_size"]
    nq, nkv, hd, V = cfg["num_attention_heads"], \
        cfg["num_key_value_heads"], cfg["head_dim"], cfg["vocab_size"]
    return {
        "tok_emb": ((V, H), H),
        "wq": ((L, H, nq * hd), H),
        "wk": ((L, H, nkv * hd), H),
        "wv": ((L, H, nkv * hd), H),
        "wo": ((L, nq * hd, H), nq * hd),
        "w_gate": ((L, H, M), H),
        "w_up": ((L, H, M), H),
        "w_down": ((L, M, H), M),
        "lm_head": ((H, V), H),
    }


def decoder_leaf(seed: int, cfg: Dict, name: str, device) -> torch.Tensor:
    """One random bf16 leaf, N(0, 1/fan_in), drawn in one call on
    ``device``; the same seed gives the same leaf."""
    shape, fan_in = decoder_shapes(cfg)[name]
    gen = torch_gen(seed, 100 + DECODER_LEAVES.index(name), device)
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.bfloat16)
    return w.mul_(1.0 / math.sqrt(fan_in))
