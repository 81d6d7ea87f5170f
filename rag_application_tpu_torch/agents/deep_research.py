"""DeepResearchAgent: gap-driven iterative research.

Copy of `rag_application_tpu/agents/deep_research.py`.

Parity: AgentAPI/app/agents/deep_research/deep_research.py —
  * 6 sub-agents: background, intent (research contract), gap analysis
    (structured GapExistence), gaps->subqueries, subquery processor,
    report generator (:141-200,359-390);
  * human-in-the-loop clarification via `interrupt` (:41-64) — here the
    run returns a `needs_clarification` status and resumes with the
    user's answer;
  * accumulated research lives in a vector-indexed store searched per
    contract item during gap analysis (:66-85,114-132).

Sub-agents are prompt-specialized calls through the same LLMRouter; the
research store is the framework's VectorMemoryStore; subqueries execute
against the knowledge toolbox (search tools), so research grounds in the
indexed corpus.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any, Dict, List, Optional, Sequence

from ..llm.router import LLMRouter
from ..tools.registry import ToolRegistry
from .base_agent import BaseAgent
from .memory import VectorMemoryStore

CONTRACT_SCHEMA = {
    "type": "object",
    "properties": {
        "needs_clarification": {"type": "boolean"},
        "clarifying_question": {"type": "string"},
        "contract": {"type": "array", "items": {"type": "string"}},
    },
}

GAP_SCHEMA = {
    "type": "object",
    "properties": {
        "gap_exists": {"type": "boolean"},
        "missing": {"type": "string"},
    },
}

SUBQUERY_SCHEMA = {
    "type": "object",
    "properties": {"subqueries": {"type": "array",
                                  "items": {"type": "string"}}},
}


class DeepResearchAgent(BaseAgent):
    agent_id = "deep_research_agent"

    def __init__(self, llm: Optional[LLMRouter] = None, *,
                 toolbox: Optional[ToolRegistry] = None,
                 research_store: Optional[VectorMemoryStore] = None,
                 max_iterations: int = 3,
                 clarify: bool = False,
                 **kw):
        super().__init__(llm, **kw)
        self.toolbox = toolbox
        self.research_store = research_store
        self.max_iterations = max_iterations
        self.clarify = clarify

    # ---------------------------------------------------------- sub-agents

    async def _intent(self, question: str,
                      clarification: Optional[str]) -> Dict[str, Any]:
        extra = (f"\nThe user clarified: {clarification}"
                 if clarification else "")
        return await self.llm.generate_structured(
            f"Research request: {question}{extra}\n"
            "Produce a research contract: the 2-5 concrete items a complete "
            "answer must cover. Set needs_clarification only if the request "
            "is too ambiguous to start.",
            CONTRACT_SCHEMA,
            system="You are a research planner.")

    async def _gap_analysis(self, item: str, thread_id: str) -> Dict[str, Any]:
        evidence: List[str] = []
        if self.research_store is not None:
            hits = self.research_store.search(("research", thread_id), item, k=4)
            evidence = [str(h.get("finding", ""))[:400] for h in hits]
        return await self.llm.generate_structured(
            f"Contract item: {item}\nEvidence collected so far:\n"
            + ("\n".join(evidence) or "(none)")
            + "\nDoes a gap remain for this item?",
            GAP_SCHEMA,
            system="You are a rigorous gap analyst.")

    async def _gaps_to_subqueries(self, gaps: Sequence[str]) -> List[str]:
        out = await self.llm.generate_structured(
            "Turn these research gaps into concrete search subqueries:\n"
            + "\n".join(gaps), SUBQUERY_SCHEMA,
            system="You write precise search queries.")
        return [q for q in out.get("subqueries", []) if q][:6]

    async def _process_subquery(self, subquery: str, thread_id: str) -> str:
        """Search the knowledge base, summarize into a finding, store it.
        A failing search records an error finding instead of aborting
        the whole research run (the gather in ainvoke would otherwise
        drop every accumulated finding on one bad subquery)."""
        results: Any = []
        if self.toolbox is not None:
            for tool_name in ("hybrid_search", "search_across_spaces"):
                t = self.toolbox.get(tool_name)
                if t is None:
                    continue
                try:
                    results = await t.call(query=subquery, k=4)
                except Exception as e:  # noqa: BLE001 — keep the run alive
                    results = [{"error": f"{tool_name} failed: {e}"}]
                if results:
                    break
        finding = await self.llm.generate_text(
            f"Subquery: {subquery}\nSearch results: "
            f"{json.dumps(results, default=str)[:4000]}\n"
            "Write a dense factual finding (2-4 sentences). If the results "
            "are empty, say what could not be found.",
            system="You are a research analyst.")
        if self.research_store is not None:
            self.research_store.put(
                ("research", thread_id), f"f-{uuid.uuid4().hex[:8]}",
                {"subquery": subquery, "finding": finding}, text=finding)
        return finding

    async def _report(self, question: str, contract: Sequence[str],
                      thread_id: str) -> str:
        findings = []
        if self.research_store is not None:
            findings = [f.get("finding", "") for f in
                        self.research_store.list(("research", thread_id))]
        return await self.llm.generate_text(
            f"Question: {question}\nContract: {json.dumps(list(contract))}\n"
            "Findings:\n" + "\n".join(f"- {f}" for f in findings)
            + "\nWrite the final research report, organized by contract item.",
            system="You write thorough, structured research reports.")

    # -------------------------------------------------------------- invoke

    async def ainvoke(self, user_input: str, *, thread_id: str = "default",
                      checkpoint_id: Optional[str] = None,
                      clarification: Optional[str] = None) -> Dict[str, Any]:
        if self.research_store is None:
            raise ValueError("DeepResearchAgent needs a research_store")
        if checkpoint_id is not None:
            # resume: a completed run's checkpoint returns its report
            # instead of silently re-spending the whole research
            saved = self.checkpointer.load(thread_id, checkpoint_id)
            if saved and saved.get("report"):
                return {"status": "complete",
                        "content": saved["report"],
                        "contract": saved.get("contract", []),
                        "iterations": 0,
                        "trace": saved.get("trace", []),
                        "checkpoint_id": checkpoint_id}
        intent = await self._intent(user_input, clarification)
        if (self.clarify and intent.get("needs_clarification")
                and clarification is None):
            # parity: interrupt() — the caller resumes with the answer
            return {"status": "needs_clarification",
                    "question": intent.get("clarifying_question", "")}
        contract = intent.get("contract") or [user_input]

        iterations = 0
        trace: List[Dict[str, Any]] = []
        while iterations < self.max_iterations:
            gap_results = await asyncio.gather(
                *(self._gap_analysis(item, thread_id) for item in contract))
            gaps = [g.get("missing") or item
                    for item, g in zip(contract, gap_results)
                    if g.get("gap_exists")]
            trace.append({"iteration": iterations, "open_gaps": len(gaps)})
            if not gaps:
                break
            subqueries = await self._gaps_to_subqueries(gaps)
            if not subqueries:
                break
            await asyncio.gather(
                *(self._process_subquery(sq, thread_id) for sq in subqueries))
            iterations += 1

        report = await self._report(user_input, contract, thread_id)
        cp = self.checkpointer.save(thread_id, {
            "question": user_input, "contract": contract, "trace": trace,
            "report": report})
        return {"status": "complete", "content": report,
                "contract": contract, "iterations": iterations,
                "trace": trace, "checkpoint_id": cp}
