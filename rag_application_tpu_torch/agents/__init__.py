"""Agent registry: the built-in agents by id.

Copy of `rag_application_tpu/agents/__init__.py`.
"""

from .base_agent import AgentState, BaseAgent
from .memory import (
    EpisodicMemory,
    ProceduralMemory,
    SemanticMemory,
    ThreadCheckpointer,
    UserProfileMemory,
    VectorMemoryStore,
)

AGENT_CLASS_MAP = {}


def register_agent(agent_id: str):
    """Parity: AGENT_CLASS_MAP registry (AgentAPI/app/agents/__init__.py:27-31)."""

    def deco(cls):
        AGENT_CLASS_MAP[agent_id] = cls
        return cls

    return deco


def get_agent_by_id(agent_id: str):
    _register_builtin()
    return AGENT_CLASS_MAP.get(agent_id)


def _register_builtin():
    """Idempotent builtin registration. Must not be gated on the map
    being empty: a caller pre-registering one agent would otherwise
    suppress every builtin, and waiter_agent was unreachable because
    nothing imported its module."""
    from . import chat_agent, waiter_agent  # noqa: F401 — register via import
    from .deep_research import DeepResearchAgent

    AGENT_CLASS_MAP.setdefault("deep_research_agent", DeepResearchAgent)


__all__ = [
    "AgentState",
    "BaseAgent",
    "VectorMemoryStore",
    "ThreadCheckpointer",
    "SemanticMemory",
    "UserProfileMemory",
    "EpisodicMemory",
    "ProceduralMemory",
    "AGENT_CLASS_MAP",
    "register_agent",
    "get_agent_by_id",
]
