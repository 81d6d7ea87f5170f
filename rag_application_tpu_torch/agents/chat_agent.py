"""ChatAgent + agents-as-tools wrappers.

Copy of `rag_application_tpu/agents/chat_agent.py`.

Parity:
  * ChatAgent — the default conversational agent with the knowledge-
    search agent bound as a tool (AgentAPI chat.py:78-100; AGENT_CLASS_MAP
    "chat_agent", agents/__init__.py:27-31).
  * KnowledgeSearchAgent — a BaseAgent binding all 21 knowledge tools
    (util_agents/knowledge_search_agent.py:58-70).
  * agents-as-tools — whole agents wrapped as single callable tools for
    composition (tools/agents_as_tools/knowledge_search.py:64).
"""

from __future__ import annotations

import uuid
from typing import Optional

from ..llm.router import LLMRouter
from ..tools.registry import Tool, ToolRegistry
from . import register_agent
from .base_agent import BaseAgent


@register_agent("knowledge_search_agent")
class KnowledgeSearchAgent(BaseAgent):
    agent_id = "knowledge_search_agent"

    def __init__(self, llm: Optional[LLMRouter] = None, *,
                 toolbox: Optional[ToolRegistry] = None, **kw):
        kw.setdefault("system_prompt",
                      "You are a knowledge-base search specialist. Use the "
                      "search tools to ground every answer; cite document "
                      "ids.")
        super().__init__(llm, **kw)
        if toolbox is not None:
            self.bind_tools([toolbox.get(n) for n in toolbox.names()])


def agent_as_tool(agent: BaseAgent, *, name: str, description: str) -> Tool:
    """Wrap a whole agent as a single tool (parity: agents_as_tools)."""

    async def run(query: str):
        tid = f"tool-{uuid.uuid4().hex}"
        out = await agent.ainvoke(query, thread_id=tid)
        # the sub-conversation is scratch: leaving it checkpointed
        # grows the shared checkpointer by one thread per tool call,
        # forever, in a long-lived server
        drop = getattr(agent.checkpointer, "drop_thread", None)
        if drop is not None:
            drop(tid)
        return {"answer": out["content"]}

    return Tool(name, description,
                {"type": "object",
                 "properties": {"query": {"type": "string"}},
                 "required": ["query"]}, run)


@register_agent("chat_agent")
class ChatAgent(BaseAgent):
    agent_id = "chat_agent"

    def __init__(self, llm: Optional[LLMRouter] = None, *,
                 knowledge_toolbox: Optional[ToolRegistry] = None, **kw):
        kw.setdefault("system_prompt",
                      "You are a helpful assistant with access to the "
                      "user's knowledge base.")
        super().__init__(llm, **kw)
        if knowledge_toolbox is not None:
            # self.llm, not the raw parameter: with llm=None the
            # sub-agent would build a SECOND independent router that
            # post-construction configuration never reaches
            search_agent = KnowledgeSearchAgent(
                self.llm, toolbox=knowledge_toolbox,
                checkpointer=self.checkpointer)
            self.bind_tools([agent_as_tool(
                search_agent, name="knowledge_search_agent",
                description="Delegate a question to the knowledge-base "
                            "search specialist agent.")])
