"""VLM processor: image content blocks -> cached text descriptions.

Copy of `rag_application_tpu/llm/vlm.py`.

Parity: AgentAPI/app/llm/utils.py VLMProcessor (:16-74,329+) — before a
text-only LLM sees a message list, every image block is replaced by a
VLM-generated description, cached by content hash so repeated images
cost one VLM call. The VLM itself is any LLMRouter (multimodal provider
or stub).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Sequence

from .router import LLMRouter

DESCRIBE_PROMPT = ("Describe this image for a text-only reader: layout, "
                   "text content, tables, figures.")


class VLMProcessor:
    def __init__(self, vlm: LLMRouter, *, cache_size: int = 4096):
        self.vlm = vlm
        self._cache: Dict[str, str] = {}
        self.cache_size = cache_size
        self.calls = 0

    @staticmethod
    def _hash(data: str) -> str:
        return hashlib.sha256(data.encode()).hexdigest()

    async def describe(self, image_b64: str) -> str:
        key = self._hash(image_b64)
        if key in self._cache:
            return self._cache[key]
        self.calls += 1
        # the IMAGE must reach the VLM: send a multimodal content-block
        # message (raw base64 wraps into a data URL; http(s)/data URLs
        # pass through). A text-only prompt with a hash tag made any
        # real provider hallucinate the description from nothing.
        url = (image_b64 if image_b64.startswith(
            ("http://", "https://", "data:"))
            else f"data:image/jpeg;base64,{image_b64}")
        from .router import ChatMessage

        resp = await self.vlm.chat([ChatMessage("user", [
            {"type": "text", "text": DESCRIBE_PROMPT},
            {"type": "image_url", "image_url": {"url": url}},
        ])])
        desc = resp.content
        if len(self._cache) >= self.cache_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = desc
        return desc

    async def process_messages(
        self, messages: Sequence[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Replace image content blocks with '[Image: description]' text
        (parity: llm/utils.py block rewriting)."""
        out = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                out.append(dict(m))
                continue
            parts = []
            for block in content:
                if not isinstance(block, dict):
                    parts.append(str(block))
                elif block.get("type") == "text":
                    parts.append(block.get("text", ""))
                elif block.get("type") in ("image", "image_url"):
                    iu = block.get("image_url") or {}
                    if isinstance(iu, str):  # OpenAI shorthand form
                        data = iu
                    else:
                        data = iu.get("url") or block.get("data", "")
                    desc = await self.describe(str(data))
                    parts.append(f"[Image: {desc}]")
            out.append(dict(m, content="\n".join(p for p in parts if p)))
        return out
