"""Agent memory: vector-indexed stores, 4 memory tiers, checkpointing.

Port of `rag_application_tpu/agents/memory.py`. The reference's indexes
name no device (JAX puts them on its default one); here every
`DenseIndex` a store makes goes on the store's device, the embedder's
(`resolve_device` of its `device`), so memories live beside the vectors
that query them. Each `put` is one `DenseIndex.insert`, one launch of the
insert prep kernel on the card.

Parity targets:
  * `BaseMemoryStore` — langgraph AsyncRedisStore with a vector
    IndexConfig (AgentAPI/app/agents/base_agents/memory/base_store.py).
    Here the store is namespaced over the framework's own DenseIndex —
    agent memories live in the same kind of HBM index as the corpus.
  * the 4 memory models — SemanticMemory SPO triples, UserProfileMemory,
    EpisodicMemoryModel (Observation/Thoughts/Action/Result),
    ProceduralMemoryModel (memory/base_memorymodels.py).
  * `BaseMemorySaver` — per-thread conversation checkpointing with
    resumable checkpoint ids (memory/base_checkpointer.py:12-29;
    base_agent.py:698-703).
"""

from __future__ import annotations

import copy
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import IndexConfig
from ..index.dense import DenseIndex
from ..utils import resolve_device


# --------------------------------------------------------------- memory models

@dataclass
class SemanticMemory:
    subject: str
    predicate: str
    object: str
    context: str = ""

    def render(self) -> str:
        return f"{self.subject} {self.predicate} {self.object}. {self.context}"


@dataclass
class UserProfileMemory:
    name: str = ""
    preferences: List[str] = field(default_factory=list)
    facts: List[str] = field(default_factory=list)

    def render(self) -> str:
        return (f"user {self.name}; preferences: {', '.join(self.preferences)};"
                f" facts: {', '.join(self.facts)}")


@dataclass
class EpisodicMemory:
    observation: str
    thoughts: str
    action: str
    result: str

    def render(self) -> str:
        return (f"observed: {self.observation}; thought: {self.thoughts}; "
                f"did: {self.action}; result: {self.result}")


@dataclass
class ProceduralMemory:
    name: str
    conditions: str
    steps: List[str] = field(default_factory=list)

    def render(self) -> str:
        return f"procedure {self.name} when {self.conditions}: " + " -> ".join(self.steps)


# ------------------------------------------------------------------- the store

class VectorMemoryStore:
    """Namespaced vector store over DenseIndex shards.

    put/search/get/delete with namespace tuples, semantic search via the
    embedder — the same surface the reference gets from its vector-indexed
    Redis store (deep_research.py:114-131 uses it for accumulated research).
    """

    def __init__(self, embedder, *, dim: Optional[int] = None):
        self.embedder = embedder
        self.dim = dim or embedder.dim
        self.device = resolve_device(getattr(embedder, "device", None))
        self._spaces: Dict[Tuple[str, ...], Dict[str, Any]] = {}

    def _space(self, namespace: Tuple[str, ...]):
        ns = tuple(namespace)
        if ns not in self._spaces:
            self._spaces[ns] = {
                "index": DenseIndex(IndexConfig(
                    dim=self.dim, matryoshka_dims=(), initial_capacity=256,
                    block_size=4096), device=self.device),
                "rows": {},      # key -> row
                "values": {},    # key -> value dict
                "vecs": {},      # key -> f32 vector (for compaction)
                "dead": 0,       # tombstoned rows since last compaction
            }
        return self._spaces[ns]

    def put(self, namespace: Sequence[str], key: str,
            value: Dict[str, Any], *, text: Optional[str] = None) -> None:
        sp = self._space(tuple(namespace))
        text = text or json.dumps(value)
        vec = self.embedder.encode([text])[0][: self.dim]
        if len(vec) < self.dim:
            vec = np.pad(vec, (0, self.dim - len(vec)))
        old = sp["rows"].get(key)
        if old is not None:
            sp["index"].delete([old])
            sp["dead"] = sp.get("dead", 0) + 1
        row = int(sp["index"].insert(vec[None, :])[0])
        sp["rows"][key] = row
        sp["values"][key] = dict(value, _key=key, _updated=time.time())
        sp["vecs"][key] = np.asarray(vec, np.float32)
        # DenseIndex.delete only tombstones; re-put keys (the 'profile'
        # key updates EVERY reflected turn) would grow the index without
        # bound. Rebuild from live vectors once dead rows dominate.
        if sp["dead"] >= max(64, len(sp["rows"])):
            self._compact(sp)

    def _compact(self, sp: Dict[str, Any]) -> None:
        from ..config import IndexConfig
        from ..index.dense import DenseIndex

        idx = DenseIndex(IndexConfig(dim=self.dim, matryoshka_dims=(),
                                     initial_capacity=256, block_size=4096),
                         device=self.device)
        keys = list(sp["rows"])
        if keys:
            mat = np.stack([sp["vecs"][k] for k in keys])
            new_rows = idx.insert(mat)
            sp["rows"] = {k: int(r) for k, r in zip(keys, new_rows)}
        else:
            sp["rows"] = {}
        sp["index"] = idx
        sp["dead"] = 0

    def get(self, namespace: Sequence[str], key: str) -> Optional[Dict[str, Any]]:
        sp = self._spaces.get(tuple(namespace))
        return sp["values"].get(key) if sp else None

    def delete(self, namespace: Sequence[str], key: str) -> None:
        sp = self._spaces.get(tuple(namespace))
        if sp and key in sp["rows"]:
            sp["index"].delete([sp["rows"].pop(key)])
            sp["values"].pop(key, None)
            sp["vecs"].pop(key, None)
            sp["dead"] = sp.get("dead", 0) + 1

    def list(self, namespace: Sequence[str]) -> List[Dict[str, Any]]:
        sp = self._spaces.get(tuple(namespace))
        return list(sp["values"].values()) if sp else []

    def search(self, namespace: Sequence[str], query: str,
               k: int = 4) -> List[Dict[str, Any]]:
        sp = self._spaces.get(tuple(namespace))
        if not sp or sp["index"].size == 0:
            return []
        qv = self.embedder.encode([query])[0][: self.dim]
        if len(qv) < self.dim:
            qv = np.pad(qv, (0, self.dim - len(qv)))
        vals, ids = sp["index"].search(qv[None, :], min(k, sp["index"].size))
        row_to_key = {r: key for key, r in sp["rows"].items()}
        out = []
        for score, row in zip(vals[0].cpu().numpy(), ids[0].cpu().numpy()):
            key = row_to_key.get(int(row))
            if key is not None and np.isfinite(score):
                # score LAST so a stored value's own "score" field can
                # never mask the retrieval similarity; internal fields
                # stay out of results (they leak into system prompts)
                v = {k2: v2 for k2, v2 in sp["values"][key].items()
                     if not k2.startswith("_")}
                out.append({**v, "_key": key, "score": float(score)})
        return out


# ---------------------------------------------------------------- checkpointer

class ThreadCheckpointer:
    """Per-thread conversation checkpointing, resumable by thread_id /
    checkpoint_id. Durable-to-disk when a directory is given; in-memory
    otherwise."""

    def __init__(self, directory: Optional[str] = None, *,
                 max_history: int = 20):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._mem: Dict[str, List[Dict[str, Any]]] = {}
        # each snapshot holds the WHOLE conversation to date, so an
        # unbounded history is O(turns^2) space and every save rewrites
        # it all; recent checkpoints are what resume actually uses
        self.max_history = max_history

    def _path(self, thread_id: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in thread_id)
        return os.path.join(self.directory, f"{safe}.json")

    def save(self, thread_id: str, state: Dict[str, Any]) -> str:
        checkpoint_id = uuid.uuid4().hex[:12]
        # deep-copy: the in-memory history must hold a SNAPSHOT — the
        # caller keeps mutating its message list, and aliased states made
        # every historic checkpoint_id resolve to the latest conversation
        entry = {"checkpoint_id": checkpoint_id, "ts": time.time(),
                 "state": copy.deepcopy(state)}
        history = self._load_history(thread_id)
        history.append(entry)
        if len(history) > self.max_history:
            history = history[-self.max_history:]
        if self.directory:
            tmp = self._path(thread_id) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(history, f)
            os.replace(tmp, self._path(thread_id))
        else:
            self._mem[thread_id] = history
        return checkpoint_id

    def _load_history(self, thread_id: str) -> List[Dict[str, Any]]:
        if self.directory:
            path = self._path(thread_id)
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
            return []
        return list(self._mem.get(thread_id, []))

    def drop_thread(self, thread_id: str) -> None:
        """Remove a thread's whole history (scratch sub-conversations —
        see chat_agent.agent_as_tool)."""
        self._mem.pop(thread_id, None)
        if self.directory:
            try:
                os.unlink(self._path(thread_id))
            except FileNotFoundError:
                pass

    def load(self, thread_id: str,
             checkpoint_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        history = self._load_history(thread_id)
        if not history:
            return None
        if checkpoint_id is None:
            return copy.deepcopy(history[-1]["state"])
        for entry in reversed(history):
            if entry["checkpoint_id"] == checkpoint_id:
                return copy.deepcopy(entry["state"])
        return None

    def list_checkpoints(self, thread_id: str) -> List[str]:
        return [e["checkpoint_id"] for e in self._load_history(thread_id)]

    def list_threads(self) -> List[Dict[str, Any]]:
        """Every stored thread with last-update time and a title (the
        first user message) — the server-side thread list the L7 chat
        page renders (parity: the reference's AgentChatUI persists
        threads via the LangGraph SDK, agent-chat-ui/package.json:1-24).

        Disk mode note: thread ids round-trip through the sanitized
        filename, so ids are reported as stored (alnum/-/_ ids — the
        server-generated `chat-<hex>` form — come back verbatim)."""
        ids: List[str] = []
        if self.directory:
            for fn in os.listdir(self.directory):
                if fn.endswith(".json"):
                    ids.append(fn[:-5])
        ids.extend(t for t in self._mem if t not in ids)
        out = []
        for tid in ids:
            history = self._load_history(tid)
            if not history:
                continue
            msgs = history[-1]["state"].get("messages", [])
            title = next((m.get("content", "") for m in msgs
                          if m.get("role") == "user"), "")
            out.append({"thread_id": tid,
                        "updated_at": history[-1]["ts"],
                        "checkpoints": len(history),
                        "title": title[:80]})
        out.sort(key=lambda t: -t["updated_at"])
        return out

    def thread_messages(self, thread_id: str) -> List[Dict[str, Any]]:
        """Latest message list of a thread ([] if unknown)."""
        state = self.load(thread_id)
        return list(state.get("messages", [])) if state else []
