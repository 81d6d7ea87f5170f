"""BaseAgent: the summarize -> llm -> tools loop.

Copy of `rag_application_tpu/agents/base_agent.py`.

Parity: the reference's LangGraph agent kernel (AgentAPI/app/agents/
base_agents/base_agent.py):
  * graph START -> summarize -> llm -> (tools -> summarize)* -> END
    (:663-686) — here a plain async loop with the same node semantics;
  * summarization node: when history exceeds `max_tokens` (32768), the
    running summary absorbs older messages down to `target_tokens` (8192)
    (:415-495; AgentAPI/app/config.py:94,106);
  * llm node builds a system precontext with UTC time + profile +
    procedural memories (:561-569), appends token usage history
    (:593-602), and submits the turn to 4 background reflection
    executors (semantic/profile/procedural/episodic) (:604-655);
  * Redis checkpointer auto-setup on compile (:698-703) -> the
    ThreadCheckpointer here;
  * bind_tools / with_structured_output / ainvoke / astream
    (:166-183,808-939).
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import json
import logging
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence

from ..llm.router import ChatMessage, LLMResponse, LLMRouter, estimate_tokens
from ..tools.registry import Tool, ToolRegistry
from .memory import ThreadCheckpointer, VectorMemoryStore

logger = logging.getLogger("rag_application_tpu.agents")

SUMMARY_PROMPT = (
    "Summarize the following conversation compactly, preserving facts, "
    "decisions, named entities and open questions:\n\n{conversation}"
)


@dataclass
class AgentState:
    messages: List[Dict[str, Any]] = field(default_factory=list)
    summary: str = ""
    context: Dict[str, Any] = field(default_factory=dict)
    token_usage_history: List[Dict[str, int]] = field(default_factory=list)
    ui: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "messages": self.messages,
            "summary": self.summary,
            "context": self.context,
            "token_usage_history": self.token_usage_history,
            "ui": self.ui,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AgentState":
        return cls(**{k: d.get(k, v) for k, v in
                      (("messages", []), ("summary", ""), ("context", {}),
                       ("token_usage_history", []), ("ui", []))})


class BaseAgent:
    agent_id = "base_agent"

    def __init__(
        self,
        llm: Optional[LLMRouter] = None,
        *,
        system_prompt: str = "You are a helpful assistant.",
        tools: Optional[Sequence[Tool]] = None,
        memory_store: Optional[VectorMemoryStore] = None,
        checkpointer: Optional[ThreadCheckpointer] = None,
        max_tokens: int = 32768,
        target_tokens: int = 8192,
        max_tool_rounds: int = 6,
        user_id: str = "default",
        reflections: bool = False,
    ):
        self.llm = llm or LLMRouter()
        self.system_prompt = system_prompt
        self.tools = ToolRegistry(list(tools or []))
        self.memory = memory_store
        self.checkpointer = checkpointer or ThreadCheckpointer()
        self.max_tokens = max_tokens
        self.target_tokens = target_tokens
        self.max_tool_rounds = max_tool_rounds
        self.user_id = user_id
        self.reflections_enabled = reflections and memory_store is not None
        self._compiled = False
        self._structured_schema: Optional[Dict[str, Any]] = None
        self._reflection_tasks: List[asyncio.Task] = []

    # ------------------------------------------------------------ builders

    def bind_tools(self, tools: Sequence[Tool]) -> "BaseAgent":
        for t in tools:
            self.tools.add(t)
        return self

    def with_structured_output(self, schema: Dict[str, Any]) -> "BaseAgent":
        self._structured_schema = schema
        return self

    def compile(self) -> "BaseAgent":
        """Parity hook: the reference sets up its checkpointer here."""
        self._compiled = True
        return self

    # ------------------------------------------------------------- nodes

    def _count_tokens(self, messages: List[Dict[str, Any]]) -> int:
        return sum(estimate_tokens(str(m.get("content") or "")) for m in messages)

    async def _summarization_node(self, state: AgentState) -> None:
        """Fold older messages into the running summary when over budget."""
        if self._count_tokens(state.messages) <= self.max_tokens:
            return
        keep: List[Dict[str, Any]] = []
        total = 0
        # keep the newest messages within the target budget
        for m in reversed(state.messages):
            t = estimate_tokens(str(m.get("content") or ""))
            if total + t > self.target_tokens and keep:
                break
            keep.append(m)
            total += t
        keep.reverse()
        # never start the keep-window on role:"tool" messages — their
        # assistant tool_calls turn would be summarized away, and
        # OpenAI-compatible providers reject a tool message with no
        # preceding tool_calls. EXTEND the window backward to the turn
        # that issued the calls instead of popping: with one oversized
        # tool result, popping would empty the window entirely and the
        # pending user question would survive only inside the lossy
        # summary.
        start = len(state.messages) - len(keep)
        while start > 0 and state.messages[start].get("role") == "tool":
            start -= 1
            keep.insert(0, state.messages[start])
        older = state.messages[:start]
        convo = "\n".join(
            f"{m['role']}: {m.get('content') or ''}" for m in older
        )
        if state.summary:
            convo = f"(previous summary) {state.summary}\n{convo}"
        state.summary = await self.llm.generate_text(
            SUMMARY_PROMPT.format(conversation=convo)
        )
        state.messages = keep

    def _precontext(self, state: AgentState) -> str:
        """System precontext: UTC time + profile + procedural memories
        (parity base_agent.py:561-569)."""
        parts = [self.system_prompt,
                 f"Current UTC time: "
                 f"{datetime.datetime.now(datetime.timezone.utc).isoformat()}"]
        if state.summary:
            parts.append(f"Conversation summary so far: {state.summary}")
        if self.memory is not None:
            last_user = next((m["content"] for m in reversed(state.messages)
                              if m["role"] == "user"), "")
            profile = self.memory.list(("memory", self.user_id, "profile"))
            if profile:
                parts.append("User profile: " + json.dumps(profile[-1]))
            if last_user:
                procs = self.memory.search(
                    ("memory", self.user_id, "procedural"), last_user, k=2)
                if procs:
                    parts.append("Relevant procedures: " + json.dumps(procs))
                sems = self.memory.search(
                    ("memory", self.user_id, "semantic"), last_user, k=4)
                if sems:
                    parts.append("Relevant memories: " + json.dumps(sems))
        return "\n\n".join(parts)

    async def _llm_node(self, state: AgentState,
                        allow_tools: bool = True) -> LLMResponse:
        msgs = [ChatMessage("system", self._precontext(state))]
        for m in state.messages:
            msgs.append(ChatMessage(
                role=m["role"], content=m.get("content") or "",
                tool_calls=m.get("tool_calls"),
                tool_call_id=m.get("tool_call_id"), name=m.get("name"),
            ))
        resp = await self.llm.chat(
            msgs,
            tools=self.tools.specs() if (len(self.tools) and allow_tools) else None,
            response_schema=self._structured_schema,
        )
        if resp.usage:
            state.token_usage_history.append(resp.usage)
        return resp

    async def _tools_node(self, state: AgentState,
                          calls: List[Dict[str, Any]]) -> None:
        results = await asyncio.gather(
            *(self.tools.execute_call(c) for c in calls)
        )
        state.messages.extend(results)

    # ---------------------------------------------------------- reflections

    async def _reflect(self, state: AgentState) -> None:
        """Background memory writes for the 4 tiers (parity :604-655)."""
        convo = "\n".join(f"{m['role']}: {m.get('content') or ''}"
                          for m in state.messages[-6:])
        schema = {
            "type": "object",
            "properties": {
                "semantic": {"type": "array", "items": {
                    "type": "object", "properties": {
                        "subject": {"type": "string"},
                        "predicate": {"type": "string"},
                        "object": {"type": "string"}}}},
                "profile_facts": {"type": "array", "items": {"type": "string"}},
                "episode": {"type": "object", "properties": {
                    "observation": {"type": "string"},
                    "thoughts": {"type": "string"},
                    "action": {"type": "string"},
                    "result": {"type": "string"}}},
                # procedural tier: durable how-to-respond rules, typically
                # born from user corrections ("don't do X", "always Y")
                # (parity: ProceduralMemoryModel + the procedural
                # reflection executor, base_agent.py:604-655)
                "procedures": {"type": "array", "items": {
                    "type": "object", "properties": {
                        "name": {"type": "string"},
                        "conditions": {"type": "string"},
                        "steps": {"type": "array",
                                  "items": {"type": "string"}}}}},
            },
        }
        try:
            data = await self.llm.generate_structured(
                "Extract memories from this exchange: semantic facts, "
                "profile facts, an episode, and procedures (durable "
                "how-to-respond rules implied by user corrections or "
                f"instructions).\n{convo}", schema)
        except ValueError:
            return
        for i, s in enumerate(data.get("semantic") or []):
            text = f"{s.get('subject','')} {s.get('predicate','')} {s.get('object','')}"
            # stable key: builtin hash() is salted per process, so the
            # same fact would duplicate after every restart
            key = hashlib.sha256(text.encode()).hexdigest()[:16]
            self.memory.put(("memory", self.user_id, "semantic"),
                            f"sem-{key}", s, text=text)
        facts = data.get("profile_facts") or []
        if facts:
            prof = (self.memory.list(("memory", self.user_id, "profile"))
                    or [{"facts": []}])[-1]
            prof.setdefault("facts", []).extend(facts)
            self.memory.put(("memory", self.user_id, "profile"), "profile",
                            prof, text=" ".join(prof["facts"]))
        ep = data.get("episode")
        if ep and any(ep.values()):
            self.memory.put(("memory", self.user_id, "episodic"),
                            f"ep-{len(state.messages)}", ep,
                            text=json.dumps(ep))
        for proc in data.get("procedures") or []:
            name = (proc.get("name") or "").strip()
            if not name and not proc.get("conditions"):
                continue
            text = (f"{name} when {proc.get('conditions', '')}: "
                    + " -> ".join(proc.get("steps") or []))
            # keyed by name so a refined rule replaces its predecessor;
            # unnamed rules key by their conditions instead (hashing ""
            # made every unnamed rule overwrite the previous one)
            ident = name or str(proc.get("conditions", ""))
            key = hashlib.sha256(ident.encode()).hexdigest()[:16]
            self.memory.put(("memory", self.user_id, "procedural"),
                            f"proc-{key}", proc, text=text)

    # ------------------------------------------------------------- invoke

    async def ainvoke(self, user_input: str, *, thread_id: str = "default",
                      checkpoint_id: Optional[str] = None) -> Dict[str, Any]:
        if not self._compiled:
            self.compile()
        saved = self.checkpointer.load(thread_id, checkpoint_id)
        state = AgentState.from_dict(saved) if saved else AgentState()
        state.messages.append({"role": "user", "content": user_input})

        await self._summarization_node(state)
        resp = await self._llm_node(state)
        rounds = 0
        while resp.tool_calls and rounds < self.max_tool_rounds:
            state.messages.append({
                "role": "assistant", "content": resp.content or "",
                "tool_calls": resp.tool_calls,
            })
            await self._tools_node(state, resp.tool_calls)
            await self._summarization_node(state)
            rounds += 1
            # at the round cap, force a final answer without tools so the
            # user never receives an empty completion
            resp = await self._llm_node(
                state, allow_tools=rounds < self.max_tool_rounds)
        state.messages.append({"role": "assistant", "content": resp.content})

        self._schedule_reflection(state)
        cp = self.checkpointer.save(thread_id, state.to_dict())
        return {
            "content": resp.content,
            "messages": state.messages,
            "summary": state.summary,
            "checkpoint_id": cp,
            "token_usage_history": state.token_usage_history,
        }

    async def astream(self, user_input: str, *, thread_id: str = "default",
                      checkpoint_id: Optional[str] = None,
                      ) -> AsyncIterator[Dict[str, Any]]:
        """Streamed variant: yields {"type": "message"|"tool"|"done", ...}
        events (parity: astream stream_mode=["messages","custom"],
        chat.py:133-140)."""
        if not self._compiled:
            self.compile()
        saved = self.checkpointer.load(thread_id, checkpoint_id)
        state = AgentState.from_dict(saved) if saved else AgentState()
        state.messages.append({"role": "user", "content": user_input})
        await self._summarization_node(state)

        rounds = 0
        while True:
            resp = await self._llm_node(
                state, allow_tools=rounds < self.max_tool_rounds)
            if resp.tool_calls and rounds < self.max_tool_rounds:
                for c in resp.tool_calls:
                    yield {"type": "tool", "name": c["function"]["name"],
                           "status": "started"}
                state.messages.append({"role": "assistant",
                                       "content": resp.content or "",
                                       "tool_calls": resp.tool_calls})
                await self._tools_node(state, resp.tool_calls)
                for c in resp.tool_calls:
                    yield {"type": "tool", "name": c["function"]["name"],
                           "status": "finished"}
                await self._summarization_node(state)
                rounds += 1
                continue
            break
        # stream the final answer in chunks
        content = resp.content
        for i in range(0, max(len(content), 1), 24):
            yield {"type": "message", "delta": content[i : i + 24]}
        state.messages.append({"role": "assistant", "content": content})
        # streamed turns reflect too (they're the chat API's main path)
        self._schedule_reflection(state)
        cp = self.checkpointer.save(thread_id, state.to_dict())
        yield {"type": "done", "checkpoint_id": cp}

    async def abatch(self, inputs: Sequence[str], *,
                     thread_prefix: str = "batch") -> List[Dict[str, Any]]:
        """Concurrent independent invocations (parity: BaseAgent.abatch,
        base_agent.py:808-939). Each input gets its own thread."""
        return list(await asyncio.gather(*(
            self.ainvoke(x, thread_id=f"{thread_prefix}-{i}")
            for i, x in enumerate(inputs))))

    async def astream_events(self, user_input: str, *,
                             thread_id: str = "default"):
        """Event-stream variant with typed envelopes (parity:
        astream_events): on_tool_start/on_tool_end/on_message/on_end."""
        async for ev in self.astream(user_input, thread_id=thread_id):
            if ev["type"] == "tool":
                yield {"event": ("on_tool_start" if ev["status"] == "started"
                                 else "on_tool_end"),
                       "name": ev["name"]}
            elif ev["type"] == "message":
                yield {"event": "on_message", "data": ev["delta"]}
            else:
                yield {"event": "on_end",
                       "checkpoint_id": ev.get("checkpoint_id")}

    def _schedule_reflection(self, state: AgentState) -> None:
        """Background memory write for a finished turn. Completed tasks
        remove themselves (a long-lived server would otherwise retain
        one Task + captured state per turn, forever) and log failures
        instead of leaving unretrieved task exceptions."""
        if not self.reflections_enabled:
            return
        task = asyncio.create_task(self._reflect(state))
        self._reflection_tasks.append(task)

        def _done(t: asyncio.Task) -> None:
            try:
                self._reflection_tasks.remove(t)
            except ValueError:
                pass  # drain_reflections cleared the list already
            if not t.cancelled() and t.exception() is not None:
                import logging

                logging.getLogger(__name__).warning(
                    "reflection failed: %r", t.exception())

        task.add_done_callback(_done)

    async def drain_reflections(self) -> None:
        """Await background memory writes (tests / clean shutdown)."""
        if self._reflection_tasks:
            await asyncio.gather(*list(self._reflection_tasks),
                                 return_exceptions=True)
            self._reflection_tasks.clear()
