"""Tool abstraction: typed async tools with OpenAI function specs.

Copy of `rag_application_tpu/tools/registry.py`.

Parity: the reference's LangChain `@tool`s with pydantic arg schemas and
YAML descriptions (AgentAPI/app/tools/core_tools/knowledge_search/
knowledge_search_tool.py:71-75,425+). Tools here are plain async
callables with JSON-schema args; `to_openai_spec` produces the wire
format every provider understands. Structured `[TOOL_CALL]` /
`[TOOL_SUCCESS]` / `[TOOL_ERROR]` logging is kept
(knowledge_search_tool.py:77-84).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("rag_application_tpu.tools")


@dataclass
class Tool:
    name: str
    description: str
    schema: Dict[str, Any]
    fn: Callable[..., Any]

    def to_openai_spec(self) -> Dict[str, Any]:
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.schema,
            },
        }

    async def call(self, **kwargs: Any) -> Any:
        logger.info("[TOOL_CALL] %s args=%s", self.name, kwargs)
        try:
            if inspect.iscoroutinefunction(self.fn):
                result = await self.fn(**kwargs)
            else:
                result = await asyncio.to_thread(self.fn, **kwargs)
        except Exception as e:
            logger.error("[TOOL_ERROR] %s: %s", self.name, e)
            raise
        logger.info("[TOOL_SUCCESS] %s", self.name)
        return result


def tool(name: str, description: str, schema: Optional[Dict[str, Any]] = None):
    """Decorator turning a function into a Tool. Without an explicit
    schema, one is derived from the signature (str/int/float/bool args)."""

    def deco(fn):
        s = schema
        if s is None:
            props: Dict[str, Any] = {}
            required = []
            hints = {"str": "string", "int": "integer", "float": "number",
                     "bool": "boolean"}
            for pname, p in inspect.signature(fn).parameters.items():
                t = getattr(p.annotation, "__name__", "str")
                props[pname] = {"type": hints.get(t, "string")}
                if p.default is inspect.Parameter.empty:
                    required.append(pname)
            s = {"type": "object", "properties": props, "required": required}
        return Tool(name=name, description=description, schema=s, fn=fn)

    return deco


class ToolRegistry:
    def __init__(self, tools: Optional[List[Tool]] = None):
        self._tools: Dict[str, Tool] = {}
        for t in tools or []:
            self.add(t)

    def add(self, t: Tool) -> None:
        self._tools[t.name] = t

    def get(self, name: str) -> Optional[Tool]:
        return self._tools.get(name)

    def names(self) -> List[str]:
        return sorted(self._tools)

    def specs(self) -> List[Dict[str, Any]]:
        return [t.to_openai_spec() for t in self._tools.values()]

    def __len__(self) -> int:
        return len(self._tools)

    async def execute_call(self, call: Dict[str, Any]) -> Dict[str, Any]:
        """Execute one OpenAI-format tool call, returning a tool message."""
        fn = call.get("function", {})
        name = fn.get("name", "")
        t = self.get(name)
        call_id = call.get("id", "call")
        if t is None:
            return {"role": "tool", "tool_call_id": call_id, "name": name,
                    "content": json.dumps({"error": f"unknown tool {name}"})}
        try:
            args = json.loads(fn.get("arguments") or "{}")
        except json.JSONDecodeError as e:
            return {"role": "tool", "tool_call_id": call_id, "name": name,
                    "content": json.dumps({"error": f"bad arguments: {e}"})}
        try:
            result = await t.call(**args)
        except Exception as e:  # noqa: BLE001 — errors flow back to the LLM
            return {"role": "tool", "tool_call_id": call_id, "name": name,
                    "content": json.dumps({"error": str(e)})}
        if not isinstance(result, str):
            result = json.dumps(result, default=str)
        return {"role": "tool", "tool_call_id": call_id, "name": name,
                "content": result}
