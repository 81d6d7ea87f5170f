"""Browser automation tool: LLM-driven action loop over a pluggable driver.

Copy of `rag_application_tpu/tools/browser.py`.

Parity: AgentAPI/app/tools/core_tools/browser_use/browser_use_tool.py
(:50-340) — an agent loop that observes the page, asks the LLM for the
next action (navigate/click/type/extract/finish), executes it against an
external browser service, and repeats up to a step budget. The browser
backend is a pluggable driver here (the reference needs a running
chrome service; tests inject a scripted fake).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Protocol

from ..llm.router import LLMRouter
from .registry import Tool

ACTION_SCHEMA = {
    "type": "object",
    "properties": {
        "action": {"type": "string",
                   "enum": ["navigate", "click", "type", "extract", "finish"]},
        "target": {"type": "string"},
        "text": {"type": "string"},
        "answer": {"type": "string"},
    },
    "required": ["action"],
}


class BrowserDriver(Protocol):  # pragma: no cover — structural type
    async def navigate(self, url: str) -> str: ...
    async def click(self, selector: str) -> str: ...
    async def type_text(self, selector: str, text: str) -> str: ...
    async def page_text(self) -> str: ...


class BrowserAgentLoop:
    def __init__(self, llm: LLMRouter, driver: BrowserDriver, *,
                 max_steps: int = 8):
        self.llm = llm
        self.driver = driver
        self.max_steps = max_steps

    async def run(self, task: str, start_url: Optional[str] = None) -> Dict[str, Any]:
        trace: List[Dict[str, Any]] = []
        page = ""
        if start_url:
            page = await self.driver.navigate(start_url)
            trace.append({"action": "navigate", "target": start_url})
        for _ in range(self.max_steps):
            try:
                decision = await self.llm.generate_structured(
                    f"Task: {task}\nCurrent page text:\n{page[:4000]}\n"
                    f"Actions so far: {json.dumps(trace[-4:])}\n"
                    "Choose the next browser action.",
                    ACTION_SCHEMA,
                    system="You operate a web browser step by step.")
            except ValueError as e:
                # distinguish a persistent structured-output failure
                # from a genuinely exhausted step budget — callers that
                # retry on `exhausted` with a bigger budget would loop
                # on an LLM/JSON failure forever
                return {"answer": "", "steps": trace,
                        "error": f"action selection failed: {e}"}
            action = decision.get("action", "finish")
            trace.append(decision)
            if action == "finish":
                return {"answer": decision.get("answer", ""),
                        "steps": trace}
            if action == "navigate":
                page = await self.driver.navigate(decision.get("target", ""))
            elif action == "click":
                page = await self.driver.click(decision.get("target", ""))
            elif action == "type":
                page = await self.driver.type_text(
                    decision.get("target", ""), decision.get("text", ""))
            elif action == "extract":
                page = await self.driver.page_text()
        return {"answer": "", "steps": trace, "exhausted": True}


def browser_tool(llm: LLMRouter, driver: BrowserDriver, *,
                 max_steps: int = 8) -> Tool:
    loop = BrowserAgentLoop(llm, driver, max_steps=max_steps)

    async def browse(task: str, start_url: str = ""):
        return await loop.run(task, start_url or None)

    return Tool(
        "browser_use",
        "Drive a web browser to complete a task; returns the answer and "
        "the action trace.",
        {"type": "object", "properties": {
            "task": {"type": "string"},
            "start_url": {"type": "string", "default": ""}},
         "required": ["task"]},
        browse)
