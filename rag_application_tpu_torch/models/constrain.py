"""Grammar-constrained decoding: JSON-schema -> byte DFA -> token table.

Port of `rag_application_tpu/models/constrain.py`: the reference's host
numpy below this header, with `Constraint.as_device(device)` handing the
table and accept vector to the port's decode loop as torch tensors.

Parity+: the reference gets schema-valid output only from providers
that implement it server-side (OpenAI structured output,
app/core/models/model_handler.py routing); its local path re-prompts
and retries. Here the constraint runs ON THE CHIP inside the fused
generation loop: a (n_states, vocab) token-transition table rides the
device, each step masks the logits to the tokens the grammar allows
from the row's current state, and eos is only reachable in accepting
states — every sampled output is valid by construction, even from a
random-init model (asserted in tests/test_constrain.py). This
generalizes `score_continuations` (exact enum choice) to full JSON.

Pipeline (all host-side, once per (schema, tokenizer)):

  1. a tiny regex AST (`Lit/Cls/Seq/Alt/Rep`) is built directly from
     the JSON-schema subset — no string regex parsing;
  2. Thompson NFA -> subset-construction DFA over BYTES;
  3. the DFA lifts to token level vectorized: walk every token's bytes
     for every DFA state with numpy gathers over a (states+1, 256)
     byte-transition matrix — `table[s, v]` is the state after emitting
     token v from state s (-1 = not allowed).

Schema subset (canonical compact JSON, keys in declaration order —
the STRUCTURE the model must emit is fixed so the DFA stays small):
object (all properties required, in order), string, integer, number,
boolean, null, enum of strings, const, arrays of any supported type.
Unsupported keywords raise, so callers can fall back to prompt-only.

The decode-side mask is exact, not heuristic: token v is allowed in
state s iff v's ENTIRE byte string keeps the DFA alive. The usual
"model paints itself into a corner" failure cannot happen: every live
DFA state has at least one outgoing byte, and `compile_schema` verifies
that each such byte is reachable through some allowed token of the
actual vocabulary (raising otherwise, e.g. a tokenizer with no '{').
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

DEAD = -1


# ---------------------------------------------------------------- regex AST


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Lit(Node):
    data: bytes


@dataclass(frozen=True)
class Cls(Node):
    """Byte class: sorted tuple of inclusive (lo, hi) ranges."""
    ranges: Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class Seq(Node):
    parts: Tuple[Node, ...]


@dataclass(frozen=True)
class Alt(Node):
    options: Tuple[Node, ...]


@dataclass(frozen=True)
class Rep(Node):
    """min..max repetitions of `inner`; max=None is unbounded."""
    inner: Node
    lo: int = 0
    hi: Optional[int] = None


def lit(s: str) -> Lit:
    return Lit(s.encode("utf-8"))


def cls(*ranges: Tuple[int, int]) -> Cls:
    return Cls(tuple(sorted(ranges)))


def seq(*parts: Node) -> Seq:
    return Seq(tuple(parts))


def alt(*options: Node) -> Alt:
    return Alt(tuple(options))


# -------------------------------------------------------------------- NFA


class _NFA:
    """Thompson construction: states are ints; transitions are
    (state, byte-range) -> state plus epsilon edges."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[int, int, int]]] = []  # (lo, hi, dst)

    def new(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def add(self, node: Node, start: int) -> int:
        """Wire `node` from `start`; return its accept state."""
        if isinstance(node, Lit):
            cur = start
            for b in node.data:
                nxt = self.new()
                self.edges[cur].append((b, b, nxt))
                cur = nxt
            return cur
        if isinstance(node, Cls):
            nxt = self.new()
            for lo, hi in node.ranges:
                self.edges[start].append((lo, hi, nxt))
            return nxt
        if isinstance(node, Seq):
            cur = start
            for p in node.parts:
                cur = self.add(p, cur)
            return cur
        if isinstance(node, Alt):
            out = self.new()
            for o in node.options:
                s = self.new()
                self.eps[start].add(s)
                self.eps[self.add(o, s)].add(out)
            return out
        if isinstance(node, Rep):
            cur = start
            for _ in range(node.lo):
                cur = self.add(node.inner, cur)
            if node.hi is None:
                loop = self.new()
                self.eps[cur].add(loop)
                end = self.add(node.inner, loop)
                self.eps[end].add(loop)
                out = self.new()
                self.eps[loop].add(out)
                return out
            # bounded optional copies: each copy's START can epsilon-skip
            # straight to the common exit, so lo..hi repetitions accept
            exits = []
            for _ in range(node.hi - node.lo):
                exits.append(cur)
                cur = self.add(node.inner, cur)
            out = self.new()
            self.eps[cur].add(out)
            for e in exits:
                self.eps[e].add(out)
            return out
        raise TypeError(f"unknown node {node!r}")


def _closure(nfa: _NFA, states: Set[int]) -> frozenset:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def compile_regex(node: Node) -> Tuple[np.ndarray, np.ndarray]:
    """AST -> byte DFA: (trans (n_states, 256) int32 with DEAD, accept
    (n_states,) bool). State 0 is the start."""
    nfa = _NFA()
    start = nfa.new()
    accept = nfa.add(node, start)

    d0 = _closure(nfa, {start})
    dfa_id: Dict[frozenset, int] = {d0: 0}
    rows: List[np.ndarray] = []
    acc: List[bool] = []
    work = [d0]
    while work:
        cur = work.pop()
        i = dfa_id[cur]
        while len(rows) <= i:
            rows.append(np.full(256, DEAD, np.int32))
            acc.append(False)
        acc[i] = accept in cur
        # group outgoing byte edges
        for b in range(256):
            tgt = {dst for s in cur for lo, hi, dst in nfa.edges[s]
                   if lo <= b <= hi}
            if not tgt:
                continue
            nxt = _closure(nfa, tgt)
            if nxt not in dfa_id:
                dfa_id[nxt] = len(dfa_id)
                work.append(nxt)
            rows[i][b] = dfa_id[nxt]
    n = len(dfa_id)
    trans = np.full((n, 256), DEAD, np.int32)
    accept_v = np.zeros(n, bool)
    for st, i in dfa_id.items():
        if i < len(rows):
            trans[i] = rows[i]
            accept_v[i] = acc[i]
    return trans, accept_v


# ------------------------------------------------------- JSON-schema -> AST

_STR_CHAR = alt(
    # unescaped: any byte except '"', '\\', and C0 controls. Multi-byte
    # UTF-8 continuation bytes are accepted freely (0x80-0xFF) — the
    # tokenizer only produces valid UTF-8 sequences anyway.
    cls((0x20, 0x21), (0x23, 0x5B), (0x5D, 0xFF)),
    seq(Lit(b"\\"), alt(cls((0x22, 0x22), (0x5C, 0x5C), (0x2F, 0x2F)),
                        Cls(tuple((ord(c), ord(c)) for c in "bfnrt")),
                        seq(Lit(b"u"), Rep(cls((0x30, 0x39), (0x41, 0x46),
                                               (0x61, 0x66)), 4, 4)))),
)

_INT = seq(Rep(Lit(b"-"), 0, 1),
           alt(Lit(b"0"), seq(cls((0x31, 0x39)),
                              Rep(cls((0x30, 0x39)), 0, None))))
_NUM = seq(_INT,
           Rep(seq(Lit(b"."), Rep(cls((0x30, 0x39)), 1, None)), 0, 1),
           Rep(seq(Cls(((0x45, 0x45), (0x65, 0x65))),
                   Rep(Cls(((0x2B, 0x2B), (0x2D, 0x2D))), 0, 1),
                   Rep(cls((0x30, 0x39)), 1, None)), 0, 1))


def _json_string_lit(s: str) -> Node:
    return Lit(json.dumps(s).encode("utf-8"))


def schema_to_regex(schema: Dict[str, Any]) -> Node:
    """JSON-schema subset -> regex AST for the canonical compact
    serialization. Raises ValueError on unsupported keywords."""
    if "enum" in schema:
        vals = schema["enum"]
        if not vals or not all(isinstance(v, str) for v in vals):
            raise ValueError("enum must be non-empty strings")
        return alt(*[_json_string_lit(v) for v in vals])
    if "const" in schema:
        return Lit(json.dumps(schema["const"],
                              separators=(",", ":")).encode("utf-8"))
    t = schema.get("type")
    if t == "string":
        lo = schema.get("minLength", 0)
        hi = schema.get("maxLength")
        return seq(Lit(b'"'), Rep(_STR_CHAR, lo, hi), Lit(b'"'))
    if t == "integer":
        lo_v, hi_v = schema.get("minimum"), schema.get("maximum")
        if lo_v is None and hi_v is None:
            return _INT
        # bounds enforce DIGIT COUNT (a regular approximation: values
        # up to the same digit length as the bound are admitted — e.g.
        # maximum 5000 admits 9999). Exact value ranges would need a
        # digit-comparison DFA; the point of the bound here is to keep
        # constrained GREEDY decode from looping on digits forever.
        digits = max(len(str(abs(int(v))))
                     for v in (lo_v, hi_v) if v is not None)
        body = alt(Lit(b"0"), seq(cls((0x31, 0x39)),
                                  Rep(cls((0x30, 0x39)), 0, digits - 1)))
        if (lo_v is not None and lo_v >= 0):
            return body
        return seq(Rep(Lit(b"-"), 0, 1), body)
    if t == "number":
        return _NUM
    if t == "boolean":
        return alt(Lit(b"true"), Lit(b"false"))
    if t == "null":
        return Lit(b"null")
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "string"}))
        body = seq(item, Rep(seq(Lit(b","), item), 0, None))
        min_items = schema.get("minItems", 0)
        if min_items > 0:
            return seq(Lit(b"["), body, Lit(b"]"))
        return seq(Lit(b"["), Rep(body, 0, 1), Lit(b"]"))
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            raise ValueError("object needs properties")
        parts: List[Node] = [Lit(b"{")]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts.append(Lit(b","))
            parts.append(_json_string_lit(key))
            parts.append(Lit(b":"))
            parts.append(schema_to_regex(sub))
        parts.append(Lit(b"}"))
        return seq(*parts)
    raise ValueError(f"unsupported schema: {schema!r}")


# ------------------------------------------------------------- token lift


def token_bytes(tokenizer, vocab_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bytes (V, maxlen) uint8, lens (V,)) — the byte string each token
    CONTRIBUTES to the decoded text, such that decode(ids) is the
    concatenation. Covers sentencepiece/BPE HF tokenizers (ids that
    decode standalone) and models/wordpiece.py (##-pieces join, plain
    pieces take a leading space — the grammar is whitespace-free, so a
    leading space makes the token grammar-dead, which simply reduces
    the allowed set; ## pieces carry their bare bytes)."""
    out: List[bytes] = []
    wp_vocab = getattr(tokenizer, "vocab", None)
    if isinstance(wp_vocab, dict) and hasattr(tokenizer, "sep_id"):
        # models/wordpiece.py
        id2tok = {i: t for t, i in wp_vocab.items()}
        for v in range(vocab_size):
            piece = id2tok.get(v, "")
            if piece.startswith("##"):
                out.append(piece[2:].encode("utf-8"))
            elif piece.startswith("[") and piece.endswith("]"):
                out.append(b"\x00")  # specials: never grammar-valid
            else:
                out.append(b" " + piece.encode("utf-8"))
    elif hasattr(tokenizer, "convert_ids_to_tokens"):
        # HF tokenizers. decode([v]) is NOT the in-context contribution
        # (it strips the sentencepiece word marker and re-decodes byte-
        # level BPE), so go through the raw pieces:
        #   * GPT2/Qwen2-style byte-level BPE: pieces are unicode-
        #     remapped bytes — invert with the byte decoder map;
        #   * sentencepiece (LLaMA/Mistral): '▁' marks a leading
        #     space; '<0xNN>' pieces are raw byte fallbacks.
        bd = getattr(tokenizer, "byte_decoder", None)
        if bd is None:
            back = getattr(tokenizer, "backend_tokenizer", None)
            pre = getattr(getattr(back, "pre_tokenizer", None),
                          "__class__", type(None)).__name__
            if pre == "ByteLevel":
                from transformers.models.gpt2.tokenization_gpt2 import (
                    bytes_to_unicode,
                )

                bd = {u: b for b, u in bytes_to_unicode().items()}
        specials = set(getattr(tokenizer, "all_special_ids", []) or [])
        for v in range(vocab_size):
            if v in specials:
                out.append(b"\x00")
                continue
            piece = tokenizer.convert_ids_to_tokens(v)
            if piece is None:
                out.append(b"\x00")
            elif bd is not None:
                try:
                    out.append(bytes(bd[c] for c in piece))
                except KeyError:
                    out.append(b"\x00")
            elif (len(piece) == 6 and piece.startswith("<0x")
                    and piece.endswith(">")):
                out.append(bytes([int(piece[3:5], 16)]))
            else:
                out.append(piece.replace("▁", " ").encode("utf-8"))
    else:
        for v in range(vocab_size):
            try:
                s = tokenizer.decode([v])
            except Exception:  # noqa: BLE001
                s = "\x00"
            out.append(s.encode("utf-8") if s else b"\x00")
    maxlen = max(1, max(len(b) for b in out))
    mat = np.zeros((vocab_size, maxlen), np.uint8)
    lens = np.zeros(vocab_size, np.int32)
    for v, b in enumerate(out):
        lens[v] = len(b)
        mat[v, :len(b)] = np.frombuffer(b, np.uint8)
    return mat, lens


def lift_to_tokens(trans: np.ndarray, accept: np.ndarray,
                   tok_bytes: np.ndarray, tok_lens: np.ndarray
                   ) -> np.ndarray:
    """(n_states, V) token table: state after emitting token v from
    state s, DEAD if any byte of v leaves the DFA. Fully vectorized:
    one (n_states, V) gather per byte position."""
    n, v = trans.shape[0], tok_bytes.shape[0]
    # dead sentinel state n absorbs everything
    tr = np.concatenate([trans, np.full((1, 256), DEAD, np.int32)])
    tr = np.where(tr == DEAD, n, tr)
    cur = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                          (n, v)).copy()
    for k in range(tok_bytes.shape[1]):
        alive = tok_lens > k                     # (V,)
        nxt = tr[cur, tok_bytes[None, :, k]]     # (n, V)
        cur = np.where(alive[None, :], nxt, cur)
    cur[:, tok_lens == 0] = n
    return np.where(cur == n, DEAD, cur).astype(np.int32)


# ------------------------------------------------------------ public entry


@dataclass
class Constraint:
    """Device-ready constraint: see decoder.generate(constraint=...).

    table  (n_states, V) int32 — next state per (state, token), -1 dead
    accept (n_states,) bool    — eos is allowed exactly here
    """
    table: Any
    accept: Any

    def as_device(self, device=None):
        """The table and accept vector as tensors on ``device`` (``cuda``
        unless the caller names another)."""
        import torch

        from ..utils.runtime import resolve_device

        dev = resolve_device(device)
        return {"table": torch.as_tensor(np.asarray(self.table), device=dev),
                "accept": torch.as_tensor(np.asarray(self.accept),
                                          device=dev)}


def compile_schema(schema: Dict[str, Any], tokenizer,
                   vocab_size: int) -> Constraint:
    """JSON schema -> token-level constraint for this tokenizer.

    Raises ValueError for schemas outside the subset, or if the
    vocabulary cannot realize the grammar (some live DFA state would
    have no allowed token — decoding could then paint itself into a
    corner, so we refuse up front)."""
    trans, accept = compile_regex(schema_to_regex(schema))
    tb, tl = token_bytes(tokenizer, vocab_size)
    table = lift_to_tokens(trans, accept, tb, tl)
    live = (trans != DEAD).any(axis=1)
    ok = (table != DEAD).any(axis=1) | accept
    bad = np.nonzero(live & ~ok)[0]
    if bad.size:
        raise ValueError(
            f"vocabulary cannot realize the grammar: DFA state(s) "
            f"{bad.tolist()} have outgoing bytes but no allowed token")
    return Constraint(table=table, accept=accept)


def stack_constraints(constraints: Sequence[Optional[Constraint]],
                      vocab_size: int, *, n_banks: Optional[int] = None,
                      min_states: int = 1) -> Constraint:
    """Pad + stack constraints into per-request-selectable banks for
    batched serving (llm/scheduler.py sampling_ext): table becomes
    (n+1, max_states, V) and accept (n+1, max_states), where bank 0 is
    the PERMISSIVE grammar (every token allowed, state stays 0, eos
    always allowed) so unconstrained rows run the same masked program
    with an identity mask. Bank i+1 = constraints[i]; states past a
    bank's own count are DEAD-padded (unreachable). `None` entries are
    permissive fillers (free bank slots); `n_banks`/`min_states`
    over-allocate the stack so the device shape stays FIXED while slots
    fill/evict — shape changes force a full recompile of every jit that
    closes over the bank (the scheduler buckets both axes to powers of
    two for exactly this reason)."""
    live = [c for c in constraints if c is not None]
    smax = max([min_states] + [c.table.shape[0] for c in live])
    n = (len(constraints) if n_banks is None
         else max(n_banks, len(constraints))) + 1
    table = np.full((n, smax, vocab_size), DEAD, np.int32)
    accept = np.zeros((n, smax), bool)
    table[0] = 0
    accept[0] = True
    for i, c in enumerate(constraints):
        if c is None:
            table[i + 1] = table[0]
            accept[i + 1] = accept[0]
            continue
        s = c.table.shape[0]
        table[i + 1, :s] = c.table
        accept[i + 1, :s] = c.accept
    # unoccupied trailing banks stay permissive too — a buggy cid can
    # then only under-constrain, never mask everything out
    for i in range(len(constraints), n - 1):
        table[i + 1] = table[0]
        accept[i + 1] = accept[0]
    return Constraint(table=table, accept=accept)


def host_accepts(trans: np.ndarray, accept: np.ndarray, data: bytes) -> bool:
    """Reference byte-DFA runner (tests)."""
    s = 0
    for b in data:
        s = int(trans[s, b])
        if s == DEAD:
            return False
    return bool(accept[s])
