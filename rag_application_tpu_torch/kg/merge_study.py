"""How long the entity merge of `kg.dedup` takes, two ways, at the size of
the chip smoke's `[kg]` phase.

    python3 -m rag_application_tpu_torch.kg.merge_study [--docs 4096]
        [--limit 600] [--device cuda]

1. A `KGStore(KGConfig(), dim=768)` gets one page for each of ``--docs``
   documents through `upsert_unstructured_page`: 32 entities drawn from a
   zipf vocabulary of 16,384 two-word names, each mention a random unit
   vector of its name at cosine ~0.95, and 24 relationships between
   them. (The smoke encodes its names with the `Embedder`; here the
   name vectors are random, so only mentions of one name are near each
   other.) `find_duplicates` gives the pairs, on the store's device.
2. The same pairs are merged twice, each time from a copy of the same
   host state: by the port's `merge_duplicates`, and by the reference's
   method (`rag_application_tpu/kg/dedup.py::merge_duplicates`) with only
   its scan of every key replaced by a row -> keys map and the losers
   tombstoned in one delete at the end (`reference_merge`). The second
   stops after ``--limit`` seconds.
3. Where both finished, the edge lists, payloads, keys and live flags
   they leave must be equal.

Prints one JSON line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import KGConfig
from ..utils import resolve_device
from .dedup import _merge_rank, find_duplicates, merge_duplicates
from .extract import ENTITY_TYPES, RELATION_TYPES, slugify
from .store import KGStore, Space

NAMES, ENTS, RELS, COS = 16384, 32, 24, 0.95


def reference_merge(kg: KGStore, pairs, deadline: float) -> Tuple[int, bool]:
    """The reference's merge loop, with a row -> keys map in place of its
    scan of every key and one delete at the end. Returns (merges, whether
    it finished before ``deadline``)."""
    table = kg.spaces[Space.ENTITY]
    edges = kg.entity_edges
    redirect: Dict[int, int] = {}

    def resolve(r: int) -> int:
        while r in redirect:
            r = redirect[r]
        return r

    keys_of: Dict[int, List[Tuple]] = {}
    for key, r in table.by_key.items():
        keys_of.setdefault(r, []).append(key)
    losers: List[int] = []
    done = True
    for a, b, _ in pairs:
        if time.perf_counter() > deadline:
            done = False
            break
        a, b = resolve(a), resolve(b)
        if a == b:
            continue
        pa, pb = table.get(a), table.get(b)
        if pa is None or pb is None:
            continue
        winner, loser = (a, b) if _merge_rank(pa) >= _merge_rank(pb) else (b, a)
        pa, pb = table.get(winner), table.get(loser)
        pa["occurrences"] = int(pa.get("occurrences", 1)) + int(
            pb.get("occurrences", 1))
        for rel_row, other in edges.pop(loser, []):
            other = resolve(other)
            if other != winner:
                edges.setdefault(winner, []).append((rel_row, other))
                if other in edges:
                    edges[other] = [
                        (rr, winner if resolve(t) == loser else resolve(t))
                        for rr, t in edges[other]]
        if winner in edges:
            edges[winner] = [(rr, t) for rr, t in edges[winner]
                             if resolve(t) != loser and t != loser]
        loser_keys = keys_of.pop(loser, [])
        table.payloads[loser] = None
        for k in loser_keys:
            table.by_key[k] = winner
        keys_of.setdefault(winner, []).extend(loser_keys)
        redirect[loser] = winner
        losers.append(loser)
    if losers:
        table.index.delete(losers)
        kg._adj_cache = None
    return len(losers), done


def unit(rng, shape) -> np.ndarray:
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def build(docs: int, device) -> KGStore:
    rng = np.random.default_rng(17)
    names = [f"name{i:05d} {i * 7919 % NAMES:05d}" for i in range(NAMES)]
    types = [ENTITY_TYPES[i] for i in rng.integers(0, len(ENTITY_TYPES),
                                                   NAMES)]
    name_vecs = unit(rng, (NAMES, 768))
    zipf = 1.0 / np.arange(1, NAMES + 1)
    zipf /= zipf.sum()
    sigma = np.sqrt(1.0 / COS ** 2 - 1.0) / np.sqrt(768)
    kg = KGStore(KGConfig(), dim=768, device=device)
    for i in range(docs):
        idx = rng.choice(NAMES, ENTS, replace=False, p=zipf)
        ents = [{"id": slugify(names[j]), "text": names[j],
                 "entity_type": types[j],
                 "entity_profile": f"{names[j]} profile"} for j in idx]
        rels, keys = [], set()
        while len(rels) < RELS:
            a, b = rng.choice(ENTS, 2, replace=False)
            t = int(rng.integers(len(RELATION_TYPES)))
            if (a, b, t) not in keys:
                keys.add((a, b, t))
                rels.append({"source": ents[a]["id"],
                             "target": ents[b]["id"],
                             "relation_type": RELATION_TYPES[t],
                             "relationship_profile": f"phrase {t}"})
        mentions = name_vecs[idx] + sigma * rng.standard_normal(
            (ENTS, 768)).astype(np.float32)
        kg.upsert_unstructured_page(
            f"doc-{i}", 1, content=f"page {i}", embedding=unit(rng, 768),
            entities=ents, relationships=rels,
            entity_embeddings=mentions,
            relationship_embeddings=unit(rng, (RELS, 768)))
    return kg


def host_state(kg: KGStore):
    table = kg.spaces[Space.ENTITY]
    return (copy.deepcopy(kg.entity_edges), copy.deepcopy(table.payloads),
            dict(table.by_key), table.index.live.clone(),
            table.index.has_deletes)


def set_state(kg: KGStore, state) -> None:
    table = kg.spaces[Space.ENTITY]
    edges, payloads, by_key, live, has_deletes = copy.deepcopy(state)
    kg.entity_edges, table.payloads, table.by_key = edges, payloads, by_key
    table.index.live, table.index.has_deletes = live, has_deletes
    kg._adj_cache = None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=4096)
    ap.add_argument("--limit", type=float, default=600.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    kg = build(args.docs, dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = find_duplicates(kg)
    find_s = time.perf_counter() - t0
    before = host_state(kg)

    t0 = time.perf_counter()
    merged = merge_duplicates(kg, pairs)
    port_s = time.perf_counter() - t0
    port = host_state(kg)

    set_state(kg, before)
    t0 = time.perf_counter()
    ref_merged, done = reference_merge(kg, pairs, t0 + args.limit)
    ref_s = time.perf_counter() - t0
    ref = host_state(kg)
    equal = None
    if done:
        equal = (port[0] == ref[0] and port[1] == ref[1]
                 and port[2] == ref[2] and torch.equal(port[3], ref[3]))
    print(json.dumps({
        "docs": args.docs, "entities": len(before[1]), "pairs": len(pairs),
        "device": str(dev), "build_s": build_s, "find_s": find_s,
        "merges": merged, "port_merge_s": port_s,
        "reference_merges": ref_merged, "reference_merge_s": ref_s,
        "reference_finished": done, "same_state": equal}), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    if equal is False:
        raise SystemExit("the two merges left different states")


if __name__ == "__main__":
    main()
