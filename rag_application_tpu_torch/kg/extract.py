"""LLM knowledge-graph extraction.

Copy of `rag_application_tpu/kg/extract.py`, on the port's `llm.router`.

Parity targets:
  * v2 `extract_entities_relationships` with the 16-entity-type /
    18-relation-type taxonomy prompt and structured parse + retry
    (IndexerAPI/src/core/model/model_handler.py:205-349, schema :28).
  * v1 `EntityRelationExtractor` with few-shot prompt, confidence-scored
    relations, continuation-chunk merging, and profile-text embedding
    (app/services/file_processor/entity_relation_extractor.py:26,58-181,
    309-340).

The extractor returns the pipeline's canonical shape:
{"entities": [{id, text, entity_type, entity_profile}],
 "relationships": [{source, target, relation_type, relationship_profile,
                    confidence}]}.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence

from ..llm.router import LLMRouter

# v2 taxonomy (model_handler.py:205-349)
ENTITY_TYPES = [
    "PERSON", "ORGANIZATION", "LOCATION", "DATE", "TIME", "MONEY",
    "PRODUCT", "EVENT", "TECHNOLOGY", "CONCEPT", "DOCUMENT", "LAW",
    "LANGUAGE", "QUANTITY", "SKILL", "OTHER",
]
RELATION_TYPES = [
    "WORKS_FOR", "LOCATED_IN", "PART_OF", "CREATED", "USES", "OWNS",
    "MEMBER_OF", "RELATED_TO", "CAUSED_BY", "PARTICIPATED_IN", "MANAGES",
    "PRODUCES", "DEPENDS_ON", "SIMILAR_TO", "OPPOSES", "SUPPORTS",
    "PRECEDES", "FOLLOWS",
]

EXTRACTION_SCHEMA = {
    "type": "object",
    "properties": {
        "entities": {"type": "array", "items": {
            "type": "object",
            "properties": {
                "id": {"type": "string"},
                "text": {"type": "string"},
                "entity_type": {"type": "string", "enum": ENTITY_TYPES},
                "entity_profile": {"type": "string"},
            },
            "required": ["id", "text", "entity_type"]}},
        "relationships": {"type": "array", "items": {
            "type": "object",
            "properties": {
                "source": {"type": "string"},
                "target": {"type": "string"},
                "relation_type": {"type": "string", "enum": RELATION_TYPES},
                "relationship_profile": {"type": "string"},
                "confidence": {"type": "number"},
            },
            "required": ["source", "target", "relation_type"]}},
    },
}

FEW_SHOT = """Example:
Text: "Ada Lovelace worked with Charles Babbage on the Analytical Engine."
Output entities: ada_lovelace (PERSON), charles_babbage (PERSON),
analytical_engine (TECHNOLOGY).
Output relationships: ada_lovelace -WORKS_FOR-> charles_babbage (0.6),
ada_lovelace -CREATED-> analytical_engine (0.9)."""

SYSTEM_PROMPT = (
    "You extract knowledge graphs from text. Entity types: "
    + ", ".join(ENTITY_TYPES) + ". Relation types: "
    + ", ".join(RELATION_TYPES) + ". Ids are lowercase snake_case of the "
    "entity text. Every relationship's source/target must be extracted "
    "entity ids. Score each relationship's confidence in [0,1].\n"
    + FEW_SHOT
)


def slugify(text: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_") or "entity"


class EntityRelationExtractor:
    def __init__(self, llm: LLMRouter, *, min_confidence: float = 0.0):
        self.llm = llm
        self.min_confidence = min_confidence

    @staticmethod
    def merge_chunks(chunks: Sequence[str], *, max_chars: int = 16000) -> List[str]:
        """Merge continuation chunks before extraction (parity:
        _merge_chunks, entity_relation_extractor.py:309-340): a chunk that
        does not start a sentence continues the previous one."""
        merged: List[str] = []
        for chunk in chunks:
            starts_sentence = bool(re.match(r"^[A-Z\"'(\[]", chunk.strip()[:1]))
            if merged and not starts_sentence and \
                    len(merged[-1]) + len(chunk) <= max_chars:
                merged[-1] = merged[-1] + " " + chunk
            else:
                merged.append(chunk)
        return merged

    def _clean(self, data: Dict[str, Any]) -> Dict[str, Any]:
        entities = []
        seen = set()
        for e in data.get("entities") or []:
            if not e.get("text"):
                continue
            eid = slugify(e.get("id") or e["text"])
            if eid in seen:
                continue
            seen.add(eid)
            etype = e.get("entity_type", "OTHER")
            entities.append({
                "id": eid,
                "text": e["text"],
                "entity_type": etype if etype in ENTITY_TYPES else "OTHER",
                "entity_profile": e.get("entity_profile", ""),
            })
        rels = []
        for r in data.get("relationships") or []:
            src, dst = slugify(r.get("source", "")), slugify(r.get("target", ""))
            if src not in seen or dst not in seen or src == dst:
                continue
            raw_conf = r.get("confidence", 0.5)
            # an explicit 0.0 means "no confidence" — `or` rewrote it to
            # 0.5 and let bogus edges through the min_confidence filter
            conf = 0.5 if raw_conf is None else float(raw_conf)
            if conf < self.min_confidence:
                continue
            rtype = r.get("relation_type", "RELATED_TO")
            rels.append({
                "source": src, "target": dst,
                "relation_type": rtype if rtype in RELATION_TYPES else "RELATED_TO",
                "relationship_profile": r.get("relationship_profile", ""),
                "confidence": conf,
            })
        return {"entities": entities, "relationships": rels}

    async def extract(self, text: str) -> Dict[str, Any]:
        try:
            data = await self.llm.generate_structured(
                f"Extract the knowledge graph from:\n{text[:12000]}",
                EXTRACTION_SCHEMA, system=SYSTEM_PROMPT)
        except ValueError:
            return {"entities": [], "relationships": []}
        return self._clean(data)

    async def extract_chunks(self, chunks: Sequence[str]) -> List[Dict[str, Any]]:
        return [await self.extract(c) for c in self.merge_chunks(chunks)]

    def as_pipeline_extractor(self):
        """Adapter for IngestPipeline(kg_extractor=...)."""
        return self.extract
