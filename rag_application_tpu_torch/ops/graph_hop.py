"""k-hop graph expansion as batched adjacency gathers.

Port of `rag_application_tpu/ops/graph_hop.py` (XLA code, no Pallas
kernel: plain torch ops on the adjacency's device).

Replaces the reference's Cypher variable-length path traversals (v1
`retrieve_knowledge_paths` `[*1..max_depth]`, v2
`execute_traverse_entity_graph` 1-3 hop expansion and `execute_bfs`).
The graph lives as a padded fixed-degree adjacency (N+1, D) with the
sentinel row N. A frontier of seed nodes expands one hop per step:
gather neighbour rows, drop nodes already visited or repeated in the
step, optionally score the new nodes against a query and keep the best
`frontier_cap` (beam-pruned expansion).

As in the reference: the hop loop runs the static `hops` times; every
top-k is `ops.topk.stable_topk` (`lax.top_k`'s tie order, toward the
lower position); unvisited slots hold the sentinel N with hop -1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .topk import NEG_INF, stable_topk


def k_hop_expand(
    adj: torch.Tensor,      # (N+1, D) int32, sentinel row N
    seeds: torch.Tensor,    # (Q, S) int32 seed ids (sentinel N = padding)
    hops: int,
    *,
    frontier_cap: int = 256,
    scores: Optional[torch.Tensor] = None,     # (N+1,) relevance per node
    node_mask: Optional[torch.Tensor] = None,  # (N+1,) bool allowed nodes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand seeds `hops` steps. Returns (visited (Q, V) int32, hop (Q, V)
    int32) where V = S + the new slots of each hop; unvisited slots hold
    the sentinel and hop -1. With `scores`, each hop keeps only the
    `frontier_cap` highest-scoring new nodes."""
    n = adj.shape[0] - 1
    deg = adj.shape[1]
    q = seeds.shape[0]
    dev = adj.device
    sentinel = torch.tensor(n, dtype=torch.int32, device=dev)
    seeds = seeds.to(device=dev, dtype=torch.int32)

    def apply_mask(ids: torch.Tensor) -> torch.Tensor:
        if node_mask is None:
            return ids
        safe = torch.clamp(ids, 0, n).long()
        return torch.where(node_mask[safe], ids, sentinel)

    visited = apply_mask(seeds)
    hop_tag = torch.where(visited < n, 0, -1).to(torch.int32)
    frontier = visited

    for h in range(1, hops + 1):
        nbrs = adj[torch.clamp(frontier, 0, n).long()].reshape(q, -1)
        nbrs = torch.where(
            torch.repeat_interleave(frontier < n, deg, dim=-1), nbrs,
            sentinel)
        nbrs = apply_mask(nbrs)
        # dedup against visited and within the step's new nodes
        seen = (nbrs[:, :, None] == visited[:, None, :]).any(dim=-1)
        pos = torch.arange(nbrs.shape[-1], device=dev)
        dup = ((nbrs[:, :, None] == nbrs[:, None, :])
               & (pos[None, :, None] > pos[None, None, :])).any(dim=-1)
        nbrs = torch.where(seen | dup, sentinel, nbrs)
        # beam-prune the new frontier to frontier_cap
        if scores is not None:
            sc = torch.where(nbrs < n,
                             scores[torch.clamp(nbrs, 0, n).long()].float(),
                             NEG_INF)
        else:
            sc = torch.where(nbrs < n, 0.0, NEG_INF)
        keep = min(frontier_cap, nbrs.shape[-1])
        top_sc, top_pos = stable_topk(sc, keep)
        new_frontier = torch.gather(nbrs, -1, top_pos)
        new_frontier = torch.where(torch.isfinite(top_sc), new_frontier,
                                   sentinel)

        visited = torch.cat([visited, new_frontier], dim=-1)
        hop_tag = torch.cat(
            [hop_tag, torch.where(new_frontier < n, h, -1).to(torch.int32)],
            dim=-1)
        frontier = new_frontier

    return visited, hop_tag


def _seed_bitmap(n: int, src: torch.Tensor) -> torch.Tensor:
    """(Q, N) bool with src[q] set (nothing for a sentinel src)."""
    q = src.shape[0]
    vis = torch.zeros((q, n), dtype=torch.bool, device=src.device)
    vis[torch.arange(q, device=src.device),
        torch.clamp(src, 0, n - 1).long()] = src < n
    return vis


def path_reachability(
    adj: torch.Tensor,   # (N+1, D)
    src: torch.Tensor,   # (Q,) int32
    dst: torch.Tensor,   # (Q,) int32
    hops: int,
) -> torch.Tensor:
    """Whether dst is reachable from src within `hops` hops (per pair).

    Dense-frontier variant: a (Q, N) visited bitmap, the
    masked-adjacency-power formulation, for moderate N (the KG's entity
    count, not the chunk corpus)."""
    n = adj.shape[0] - 1
    src, dst = src.to(adj.device), dst.to(adj.device)
    visited = _seed_bitmap(n, src)
    for _ in range(hops):
        visited = _expand_frontier(adj, visited)
    ok = visited[torch.arange(src.shape[0], device=adj.device),
                 torch.clamp(dst, 0, n - 1).long()]
    return torch.where(dst < n, ok, False)


def _expand_frontier(adj: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """One BFS step over the padded adjacency: for each node i visited,
    mark adj[i]: new[q, j] = any_i vis[q, i] & (adj[i, :] == j), a
    scatter-max per degree slot (as uint8: torch's scatter_reduce takes
    no bool)."""
    n = adj.shape[0] - 1
    q = vis.shape[0]
    src = vis[:, :n].to(torch.uint8)
    new = vis
    for dslot in range(adj.shape[1]):
        col = torch.clamp(adj[:n, dslot], 0, n).long()  # (N,)
        contrib = torch.zeros((q, n + 1), dtype=torch.uint8,
                              device=vis.device)
        contrib.scatter_reduce_(1, col[None, :].expand(q, n), src,
                                reduce="amax")
        new = new | contrib[:, :n].bool()
    return new


def path_first_hop(
    adj: torch.Tensor,   # (N+1, D)
    src: torch.Tensor,   # (Q,) int32
    dst: torch.Tensor,   # (Q,) int32
    hops: int,
) -> torch.Tensor:
    """Smallest hop count (0..hops) at which dst is reachable from src;
    -1 when not reachable within `hops`. 0 means src == dst."""
    n = adj.shape[0] - 1
    src, dst = src.to(adj.device), dst.to(adj.device)
    q = src.shape[0]
    visited = _seed_bitmap(n, src)
    d_idx = torch.clamp(dst, 0, n - 1).long()
    d_ok = dst < n
    first = torch.where((src == dst) & (src < n) & d_ok, 0,
                        -1).to(torch.int32)
    rows = torch.arange(q, device=adj.device)
    for h in range(hops):
        visited = _expand_frontier(adj, visited)
        at_dst = visited[rows, d_idx] & d_ok
        first = torch.where((first < 0) & at_dst, h + 1, first).to(
            torch.int32)
    return first
