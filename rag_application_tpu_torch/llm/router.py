"""LLM provider router.

Copy of `rag_application_tpu/llm/router.py`, with `Provider.LOCAL`
serving the port's `llm/local.py::LocalLLM`.

Parity surfaces:
  * v1 `ModelRouter` dispatching to OpenAI/Ollama/HF by Provider enum with
    availability checks (app/core/models/model_handler.py:9-145).
  * v2 `LLM` wrapper with reasoning/utility/VLM model trio and
    per-provider param allowlists (AgentAPI/app/llm/llm.py:20-25,135+).
  * structured output via JSON-schema response formats (openai.py:115-166;
    ollama.py:102-146).
  * ModelRouterAPI's OpenAI-compatible facade (SURVEY §2.4).

All remote providers speak the OpenAI-compatible chat protocol over
httpx (Ollama exposes /v1 as well). `StubLLM` is the hermetic in-process
provider used by tests and offline runs: deterministic, schema-aware,
instantly available. LLM-in-the-loop stages elsewhere in the framework
(context generation, KG extraction, parameter tuning) accept any
provider through this one interface, so the core engine benchmarks
without network dependencies (SURVEY §7.4).
"""

from __future__ import annotations

import asyncio
import enum
import json
import re
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Sequence


class Provider(str, enum.Enum):
    """Parity: ModelRouter's Provider enum (app/core/models/
    model_handler.py:9) plus the AgentAPI factory's azure_ai / bedrock /
    google providers (AgentAPI/app/llm/provider_factory.py:6-60).
    GOOGLE rides Gemini's OpenAI-compatible endpoint; BEDROCK speaks the
    Converse API with stdlib SigV4 (llm/bedrock.py)."""

    OPENAI = "openai"
    AZURE = "azure"
    OLLAMA = "ollama"
    GOOGLE = "google"
    BEDROCK = "bedrock"
    # on-device generation: the decoder in models/decoder.py served
    # through llm/local.py (parity: the reference's HF local text
    # generation, app/core/models/huggingface/huggingface.py:17-22)
    LOCAL = "local"
    STUB = "stub"


@dataclass
class ChatMessage:
    role: str
    content: str
    tool_calls: Optional[List[Dict[str, Any]]] = None
    tool_call_id: Optional[str] = None
    name: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"role": self.role, "content": self.content}
        if self.tool_calls:
            out["tool_calls"] = self.tool_calls
        if self.tool_call_id:
            out["tool_call_id"] = self.tool_call_id
        if self.name:
            out["name"] = self.name
        return out


@dataclass
class LLMResponse:
    content: str
    tool_calls: List[Dict[str, Any]] = field(default_factory=list)
    usage: Dict[str, int] = field(default_factory=dict)
    raw: Optional[Dict[str, Any]] = None
    # OpenAI-style per-token logprobs [{"token","logprob"}, ...] —
    # populated by the local provider when the request asks for them
    logprobs: Optional[List[Dict[str, Any]]] = None


def estimate_tokens(text: str) -> int:
    """Cheap token estimate (~4 chars/token) used by summarization
    budgets — the reference counts with the provider tokenizer; the
    budgets only need to be approximately right."""
    return max(1, len(text) // 4)


class StubLLM:
    """Deterministic offline provider.

    Behaviors: echoes a digest of the conversation; honors
    `response_schema` by emitting a minimal valid instance; calls a tool
    when the latest user message contains "use <tool_name>"; summarizes
    by head/tail truncation. Register custom behaviors per-test with
    `on(pattern, fn)`.
    """

    def __init__(self):
        self._rules: List = []

    def on(self, pattern: str, fn: Callable[[str], str]) -> None:
        self._rules.append((re.compile(pattern, re.I | re.S), fn))

    @staticmethod
    def _minimal_instance(schema: Dict[str, Any]) -> Any:
        t = schema.get("type", "object")
        if "default" in schema:
            return schema["default"]
        if "enum" in schema:
            return schema["enum"][0]
        if t == "object":
            return {
                k: StubLLM._minimal_instance(v)
                for k, v in schema.get("properties", {}).items()
            }
        if t == "array":
            return []
        if t == "string":
            return "stub"
        if t in ("integer", "number"):
            return 0
        if t == "boolean":
            return False
        return None

    async def chat(self, messages: Sequence[ChatMessage], *,
                   tools: Optional[Sequence[Dict[str, Any]]] = None,
                   response_schema: Optional[Dict[str, Any]] = None,
                   **_: Any) -> LLMResponse:
        last_user = next(
            (m.content for m in reversed(messages) if m.role == "user"), ""
        )
        if not isinstance(last_user, str):  # multimodal content blocks
            last_user = json.dumps(last_user, default=str)
        for pat, fn in self._rules:
            m = pat.search(last_user)
            if m:
                out = fn(last_user)
                return LLMResponse(content=out,
                                   usage={"total_tokens": estimate_tokens(out)})
        if tools:
            m = re.search(r"use (\w+)", last_user, re.I)
            names = {t["function"]["name"] for t in tools}
            if m and m.group(1) in names:
                return LLMResponse(
                    content="",
                    tool_calls=[{
                        "id": "call_0",
                        "type": "function",
                        "function": {"name": m.group(1),
                                     "arguments": json.dumps({"query": last_user})},
                    }],
                )
        if response_schema is not None:
            inst = self._minimal_instance(response_schema)
            return LLMResponse(content=json.dumps(inst))
        digest = last_user[:160]
        out = f"[stub] {digest}"
        return LLMResponse(content=out,
                           usage={"total_tokens": estimate_tokens(out)})

    async def stream(self, messages, **kw) -> AsyncIterator[str]:
        resp = await self.chat(messages, **kw)
        for i in range(0, len(resp.content), 16):
            yield resp.content[i : i + 16]


class LLMRouter:
    """Routes chat/structured/stream calls to a provider.

    `generate_structured` parses the model's JSON against the supplied
    schema with bounded retries (parity: the retry loop in
    app/core/agent/base_agent.py:100-118 and IndexerAPI
    model_handler.py:325-349).
    """

    # per-provider request param allowlist (parity: llm.py:20-25)
    _PARAM_ALLOWLIST = {
        Provider.OPENAI: {"temperature", "max_tokens", "top_p", "stop",
                          "presence_penalty", "frequency_penalty", "seed",
                          "logit_bias"},
        Provider.AZURE: {"temperature", "max_tokens", "top_p", "stop"},
        Provider.OLLAMA: {"temperature", "max_tokens", "top_p", "stop", "seed"},
        Provider.GOOGLE: {"temperature", "max_tokens", "top_p", "stop"},
        Provider.BEDROCK: {"temperature", "max_tokens", "top_p", "stop"},
        Provider.LOCAL: {"temperature", "max_tokens", "top_p", "stop",
                         "seed", "logprobs", "adapter",
                         "presence_penalty", "frequency_penalty",
                         "logit_bias"},
        Provider.STUB: set(),
    }

    def __init__(
        self,
        provider: Provider = Provider.STUB,
        *,
        model: str = "stub-model",
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        stub: Optional[StubLLM] = None,
        local: Optional[Any] = None,  # llm.local.LocalLLM
        max_retries: int = 3,
        timeout: float = 120.0,
    ):
        self.provider = Provider(provider)
        self.model = model
        self.base_url = base_url or {
            Provider.OPENAI: "https://api.openai.com/v1",
            Provider.AZURE: None,
            Provider.OLLAMA: "http://localhost:11434/v1",
            # Gemini's OpenAI-compatible surface
            Provider.GOOGLE:
                "https://generativelanguage.googleapis.com/v1beta/openai",
            Provider.BEDROCK: None,  # endpoint built per request (region)
            Provider.LOCAL: None,   # on-chip, no endpoint
            Provider.STUB: None,
        }[self.provider]
        self.api_key = api_key
        self.stub = stub or StubLLM()
        self.local = local
        if self.provider == Provider.LOCAL and self.local is None:
            raise ValueError(
                "Provider.LOCAL needs a LocalLLM instance: "
                "LLMRouter(Provider.LOCAL, local=LocalLLM(...)) — build one "
                "from decoder params, a config and a tokenizer (llm/local.py)")
        if (self.provider in (Provider.AZURE,) and not self.base_url):
            # fail at construction, not as UnsupportedProtocol('None/...')
            # deep inside the first request
            raise ValueError("Provider.AZURE needs base_url (the Azure "
                             "OpenAI deployment endpoint)")
        self.max_retries = max_retries
        self.timeout = timeout
        self._bedrock = None
        if self.provider == Provider.BEDROCK:
            from .bedrock import BedrockClient

            self._bedrock = BedrockClient(model=model, timeout=timeout)

    # ------------------------------------------------------------- plumbing

    def _filter_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        allow = self._PARAM_ALLOWLIST[self.provider]
        return {k: v for k, v in params.items() if k in allow}

    def _http_headers(self) -> Dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            if self.provider == Provider.AZURE:
                # Azure OpenAI key auth uses the api-key header, not a
                # Bearer token
                headers["api-key"] = self.api_key
            else:
                headers["Authorization"] = f"Bearer {self.api_key}"
        return headers

    def _client(self):
        """One keep-alive AsyncClient per event loop (a per-call client
        pays TCP+TLS setup for every request; a single cached client is
        loop-bound, so cache by the running loop — tests run many
        asyncio.run() loops against one router)."""
        import asyncio as _asyncio

        import httpx

        loop = _asyncio.get_running_loop()
        if getattr(self, "_client_loop", None) is not loop:
            self._client_obj = httpx.AsyncClient(timeout=self.timeout)
            self._client_loop = loop
        return self._client_obj

    async def _http_chat(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        r = await self._client().post(
            f"{self.base_url}/chat/completions", json=payload,
            headers=self._http_headers(),
        )
        r.raise_for_status()
        return r.json()

    # ------------------------------------------------------------------ API

    async def chat(
        self,
        messages: Sequence[ChatMessage],
        *,
        tools: Optional[Sequence[Dict[str, Any]]] = None,
        response_schema: Optional[Dict[str, Any]] = None,
        **params: Any,
    ) -> LLMResponse:
        if self.provider == Provider.STUB:
            return await self.stub.chat(messages, tools=tools,
                                        response_schema=response_schema,
                                        **params)
        if self.provider == Provider.LOCAL:
            # tool use is prompt-mediated for local models (no grammar
            # constraint); agents relying on tool_calls should route to a
            # provider with native tool support
            return await self.local.chat(messages,
                                         response_schema=response_schema,
                                         **self._filter_params(params))
        if self.provider == Provider.BEDROCK:
            from .bedrock import from_converse

            msgs = list(messages)
            if response_schema is not None:
                # Converse has no response_format; instruct instead — the
                # generate_structured retry loop validates the JSON
                msgs.append(ChatMessage(
                    "user", "Respond with ONLY valid JSON matching this "
                            f"schema: {json.dumps(response_schema)}"))
            data = await self._bedrock.converse(
                msgs, tools=tools, **self._filter_params(params))
            content, tool_calls, usage = from_converse(data)
            return LLMResponse(content=content, tool_calls=tool_calls,
                               usage=usage, raw=data)
        payload: Dict[str, Any] = {
            "model": self.model,
            "messages": [m.to_dict() for m in messages],
            **self._filter_params(params),
        }
        if tools:
            payload["tools"] = list(tools)
        if response_schema is not None:
            payload["response_format"] = {
                "type": "json_schema",
                "json_schema": {"name": "structured", "schema": response_schema},
            }
        data = await self._http_chat(payload)
        choice = data["choices"][0]["message"]
        return LLMResponse(
            content=choice.get("content") or "",
            tool_calls=choice.get("tool_calls") or [],
            usage=data.get("usage") or {},
            raw=data,
        )

    async def generate_text(self, prompt: str, *, system: Optional[str] = None,
                            **params: Any) -> str:
        msgs = []
        if system:
            msgs.append(ChatMessage("system", system))
        msgs.append(ChatMessage("user", prompt))
        return (await self.chat(msgs, **params)).content

    async def generate_structured(
        self,
        prompt: str,
        schema: Dict[str, Any],
        *,
        system: Optional[str] = None,
        **params: Any,
    ) -> Any:
        msgs = []
        if system:
            msgs.append(ChatMessage("system", system))
        msgs.append(ChatMessage("user", prompt))
        # top-level enum schemas on the LOCAL provider skip the
        # prompt-and-retry loop entirely: exact choice scoring
        # (decoder.score_continuations) GUARANTEES a valid option —
        # the on-chip answer to server-side constrained output
        enum_vals = schema.get("enum")
        if (enum_vals and self.provider == Provider.LOCAL
                and self.local is not None
                and all(isinstance(v, str) for v in enum_vals)):
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, self.local.choose_text, msgs, list(enum_vals))
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            resp = await self.chat(msgs, response_schema=schema, **params)
            try:
                text = resp.content.strip()
                # tolerate fenced output
                if text.startswith("```"):
                    text = re.sub(r"^```(json)?|```$", "", text, flags=re.M).strip()
                parsed = json.loads(text)
                # top-level TYPE check: json.loads accepting a bare
                # string/array is not "valid structured output" for an
                # object schema — callers index into the result, so a
                # mismatch must retry here, not AttributeError there
                want = schema.get(
                    "type", "object" if "properties" in schema else None)
                py = {"object": dict, "array": list, "string": str,
                      "integer": int, "number": (int, float),
                      "boolean": bool}.get(want)
                if py is not None and not isinstance(parsed, py):
                    raise ValueError(
                        f"expected {want}, got {type(parsed).__name__}")
                if "enum" in schema and parsed not in schema["enum"]:
                    raise ValueError(f"{parsed!r} not in enum")
                return parsed
            except (json.JSONDecodeError, ValueError) as e:
                last_err = e
                msgs.append(ChatMessage("assistant", resp.content))
                msgs.append(ChatMessage(
                    "user", "That was not valid JSON. Reply with ONLY valid "
                            "JSON matching the schema."))
        raise ValueError(f"structured output failed after "
                         f"{self.max_retries} attempts: {last_err}")

    async def stream(self, messages: Sequence[ChatMessage],
                     **params: Any) -> AsyncIterator[str]:
        if self.provider == Provider.STUB:
            async for chunk in self.stub.stream(messages, **params):
                yield chunk
            return
        if self.provider == Provider.LOCAL:
            async for chunk in self.local.stream(
                    messages, **self._filter_params(params)):
                yield chunk
            return
        if self.provider == Provider.BEDROCK:
            # real ConverseStream: AWS binary eventstream frames parsed
            # in llm/bedrock.py — TTFT is the model's first delta
            async for kind, payload in self._bedrock.converse_stream(
                    messages, **self._filter_params(params)):
                if kind == "contentBlockDelta":
                    delta = (payload.get("delta") or {}).get("text")
                    if delta:
                        yield delta
            return
        payload = {
            "model": self.model,
            "messages": [m.to_dict() for m in messages],
            "stream": True,
            **self._filter_params(params),
        }
        async with self._client().stream(
            "POST", f"{self.base_url}/chat/completions", json=payload,
            headers=self._http_headers(),
        ) as r:
            if r.status_code >= 400:
                # httpx does not raise inside stream(); an error body has
                # no data: lines, so without this the caller would see an
                # EMPTY successful stream instead of the auth/model error
                body = (await r.aread()).decode("utf-8", errors="replace")
                raise ValueError(
                    f"stream request failed ({r.status_code}): "
                    f"{body[:500]}")
            async for line in r.aiter_lines():
                if not line.startswith("data:"):
                    continue
                data = line[5:].strip()
                if data == "[DONE]":
                    break
                delta = (json.loads(data)["choices"][0]
                         .get("delta", {}).get("content"))
                if delta:
                    yield delta
