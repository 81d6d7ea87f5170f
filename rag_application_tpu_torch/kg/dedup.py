"""Entity deduplication job.

Port of `rag_application_tpu/kg/dedup.py`. It finds the same pairs and
makes the same merges as the reference, with these changes of method:
the self-kNN runs in query blocks, so the score tile of one block of
queries against one corpus block stays near `_KNN_TILE` f32 elements
(all entities against a 65,536-row block at once would be tens of GB);
`merge_duplicates` keeps a row -> keys map, tombstones the losers in one
delete at the end, and resolves the neighbours' edge lists it rewrites
once at the end (where the reference scans every key, launches a delete
and rewrites whole lists per merge); identical strings skip the
edit-distance table (ratio 1.0).

Parity: the reference's background deduplicator (app/core/graph_db/
neo4j/deduplicator.py): per user, vector kNN (score > 0.85) AND string
similarity > 0.8 AND same entity type -> duplicates (:35-43); keep the
best by occurrence count then text length (:86-131); merge via apoc
mergeNodes (:69-75); repeats on an interval (:161-169).

Device design: the candidate pass is a batched self-kNN of the entity
space (every entity queries every other: dense products), then the host
applies the string filter and merges. Merging keeps
the winner row and tombstones losers, rewiring their edges onto the
winner.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .store import KGStore, Space

# f32 elements of one (queries x corpus block) score tile in the self-kNN
_KNN_TILE = 1 << 28


def _levenshtein_ratio(a: str, b: str) -> float:
    """difflib-free normalized edit similarity (the reference uses
    python-Levenshtein's ratio; this is the same metric)."""
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if not la or not lb:
        return 0.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ca = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    dist = prev[lb]
    return 1.0 - dist / max(la, lb)


def find_duplicates(
    kg: KGStore,
    *,
    k: int = 8,
    score_threshold: Optional[float] = None,
    string_threshold: Optional[float] = None,
) -> List[Tuple[int, int, float]]:
    """Candidate duplicate entity pairs (row_a < row_b, cosine score)."""
    if score_threshold is None:  # `or` would discard an explicit 0.0
        score_threshold = kg.cfg.dedup_score_threshold
    if string_threshold is None:
        string_threshold = kg.cfg.dedup_string_threshold
    table = kg.spaces[Space.ENTITY]
    n = table.index.size
    if n < 2:
        return []
    index = table.index
    live = index.live[:n].cpu().numpy()
    k_eff = min(k + 1, n)
    # queries a block: rows are independent, so the blocks' results are
    # the rows of one search over all n
    q_rows = max(1, _KNN_TILE // min(index.cfg.block_size, index.capacity))
    vals = np.empty((n, k_eff), dtype=np.float32)
    ids = np.empty((n, k_eff), dtype=np.int32)
    for s in range(0, n, q_rows):
        e = min(s + q_rows, n)
        v, i = index.search(index.vecs[s:e].float(), k_eff)
        vals[s:e], ids[s:e] = v.cpu().numpy(), i.cpu().numpy()

    pairs = []
    seen = set()
    for row in range(n):
        if not live[row]:
            continue
        pa = table.get(row)
        if pa is None:
            continue
        for score, other in zip(vals[row], ids[row]):
            other = int(other)
            if other == row or not np.isfinite(score):
                continue
            if score < score_threshold:
                continue
            key = (min(row, other), max(row, other))
            if key in seen:
                continue
            seen.add(key)
            pb = table.get(other)
            if pb is None:
                continue
            if pa.get("entity_type") != pb.get("entity_type"):
                continue
            sim = _levenshtein_ratio(
                str(pa.get("text", "")).lower(), str(pb.get("text", "")).lower()
            )
            if sim >= string_threshold:
                pairs.append((key[0], key[1], float(score)))
    return pairs


def _merge_rank(payload: Dict) -> Tuple[int, int]:
    """Keep-best ordering: occurrence count, then text length (parity:
    deduplicator.py:86-131)."""
    return (int(payload.get("occurrences", 1)), len(str(payload.get("text", ""))))


class _Roots:
    """The merge's redirects (loser -> winner, each with its merge step)
    and, for each live row r, which edge lists hold how many edges whose
    target resolves to r (so a winner's list is filtered only when it
    holds an edge to the loser)."""

    def __init__(self, edges: Dict[int, List[Tuple[int, int]]]):
        self.redirect: Dict[int, int] = {}
        self.step: Dict[int, int] = {}
        self.holders: Dict[int, Dict[int, int]] = {}
        for owner, lst in edges.items():
            for _, t in lst:
                self.count(t, owner, 1)

    def resolve(self, r: int) -> int:
        while r in self.redirect:
            r = self.redirect[r]
        return r

    def resolve_at(self, r: int, step: int) -> int:
        """``r`` through the redirects made at merge steps <= ``step``."""
        while r in self.redirect and self.step[r] <= step:
            r = self.redirect[r]
        return r

    def count(self, root: int, owner: int, n: int) -> None:
        held = self.holders.setdefault(root, {})
        held[owner] = held.get(owner, 0) + n
        if not held[owner]:
            del held[owner]

    def merge(self, loser: int, winner: int, step: int) -> None:
        self.redirect[loser] = winner
        self.step[loser] = step
        src = self.holders.pop(loser, None)
        if not src:
            return
        dst = self.holders.setdefault(winner, {})
        if len(src) > len(dst):  # fold the smaller map into the larger
            src, dst = dst, src
            self.holders[winner] = dst
        for owner, n in src.items():
            dst[owner] = dst.get(owner, 0) + n


def merge_duplicates(kg: KGStore, pairs: List[Tuple[int, int, float]]) -> int:
    """Merge each duplicate pair: winner keeps edges + summed occurrence
    count; loser is tombstoned. Returns number of merges.

    The reference's edge rewrites, with the same result: where it
    rewrites a neighbour's whole edge list to resolved targets, this
    records the merge step instead (`rewritten`) and resolves the list's
    targets through the redirects up to that step once, at the end;
    the winner's list is filtered only when `_Roots` says it holds an
    edge to the loser. Each merge then costs the loser's edges, not the
    neighbours' lists (a name merged across thousands of pages would
    otherwise rewrite its own list once per merge)."""
    table = kg.spaces[Space.ENTITY]
    edges = kg.entity_edges
    roots = _Roots(edges)
    resolve = roots.resolve
    rewritten: Dict[int, int] = {}  # list owner -> step of its last rewrite
    # row -> its keys (the reference scans every key per merge)
    keys_of: Dict[int, List[Tuple]] = {}
    for key, r in table.by_key.items():
        keys_of.setdefault(r, []).append(key)
    losers: List[int] = []
    merged = 0

    for a, b, _ in pairs:
        a, b = resolve(a), resolve(b)
        if a == b:
            continue
        pa, pb = table.get(a), table.get(b)
        if pa is None or pb is None:
            continue
        winner, loser = (a, b) if _merge_rank(pa) >= _merge_rank(pb) else (b, a)
        wp = table.get(winner)
        lp = table.get(loser)
        wp["occurrences"] = int(wp.get("occurrences", 1)) + int(
            lp.get("occurrences", 1)
        )
        step = merged
        # rewire loser edges onto the winner
        rewritten.pop(loser, None)
        for rel_row, other in edges.pop(loser, []):
            other = resolve(other)
            roots.count(other, loser, -1)
            if other != winner:
                edges.setdefault(winner, []).append((rel_row, other))
                roots.count(other, winner, 1)
                if other in edges:
                    # the reference resolves every target of this list
                    # now, the loser's to the winner
                    rewritten[other] = step
        # drop the winner's own edges to the tombstoned loser (a
        # winner-loser relationship would otherwise point at a dead row
        # forever: entity_context returned neighbor=None for it)
        if winner in edges and roots.holders.get(loser, {}).get(winner):
            edges[winner] = [(rr, t) for rr, t in edges[winner]
                             if resolve(t) != loser]
            del roots.holders[loser][winner]
        # loser key now points at the winner (future MERGEs hit the winner)
        loser_keys = keys_of.pop(loser, [])
        losers.append(loser)
        table.payloads[loser] = None
        for k in loser_keys:
            table.by_key[k] = winner
        keys_of.setdefault(winner, []).extend(loser_keys)
        roots.merge(loser, winner, step)
        merged += 1
    for owner, step in rewritten.items():
        edges[owner] = [(rr, roots.resolve_at(t, step))
                        for rr, t in edges[owner]]
    if merged:
        table.index.delete(losers)
        kg._adj_cache = None
    return merged


def deduplicate(kg: KGStore, **kw) -> int:
    """One full dedup pass (parity: deduplicate_user_graph). Holds the
    store's mutation lock so a concurrent checkpoint snapshot never sees
    a half-merged entity table."""
    with kg.lock:
        return merge_duplicates(kg, find_duplicates(kg, **kw))


async def deduplication_loop(kg: KGStore, *, interval: float = 300.0,
                             stop_event=None, **kw) -> int:
    """Background loop re-running dedup every `interval` seconds (parity:
    start_deduplication, deduplicator.py:161-169). Stops when
    `stop_event` (asyncio.Event) is set; returns total merges."""
    import asyncio

    total = 0
    while stop_event is None or not stop_event.is_set():
        total += deduplicate(kg, **kw)
        try:
            if stop_event is not None:
                await asyncio.wait_for(stop_event.wait(), timeout=interval)
            else:
                await asyncio.sleep(interval)
        except asyncio.TimeoutError:
            pass
    return total
