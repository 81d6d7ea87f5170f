"""AWS Bedrock Converse client (stdlib SigV4, no boto3).

Copy of `rag_application_tpu/llm/bedrock.py`.

Parity: the reference's agent LLM factory routes provider "bedrock"
through langchain's ChatBedrockConverse (AgentAPI/app/llm/
provider_factory.py:6-60). This module speaks the same Converse API
directly: OpenAI-style messages map to Converse turns (system prompts to
the `system` list, tool calls to `toolUse` blocks, tool results to
`toolResult` blocks) and the response maps back to the router's
LLMResponse shape.

Requests are signed with AWS Signature V4 (hashlib/hmac only — boto3 is
not a framework dependency). Credentials come from the standard env vars
(AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / AWS_SESSION_TOKEN /
AWS_REGION). The HTTP send is injectable for tests.

Streaming: `converse_stream` speaks the ConverseStream endpoint, whose
wire format is the AWS binary eventstream (`application/
vnd.amazon.eventstream`) — length-prefixed frames with CRC32-guarded
prelude and message, string headers carrying `:event-type`, and a JSON
payload per event. `parse_eventstream`/`encode_event` implement that
framing in stdlib (struct + zlib.crc32), so time-to-first-token is the
model's, not the full completion's (ChatBedrockConverse parity).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import struct
import urllib.parse
import zlib
from typing import (Any, AsyncIterator, Awaitable, Callable, Dict, List,
                    Optional, Sequence, Tuple)

SERVICE = "bedrock"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_request(
    *,
    method: str,
    url: str,
    body: bytes,
    access_key: str,
    secret_key: str,
    region: str,
    session_token: Optional[str] = None,
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """AWS SigV4 headers for a bedrock-runtime request."""
    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    path = urllib.parse.quote(parsed.path or "/")
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")

    payload_hash = hashlib.sha256(body).hexdigest()
    headers: Dict[str, str] = {
        "content-type": "application/json",
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    if session_token:
        headers["x-amz-security-token"] = session_token

    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(
        f"{k}:{headers[k].strip()}\n" for k in sorted(headers))
    canonical_request = "\n".join([
        method, path, "", canonical_headers, signed_names, payload_hash])

    scope = f"{date_stamp}/{region}/{SERVICE}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    k = _hmac(f"AWS4{secret_key}".encode(), date_stamp)
    k = _hmac(k, region)
    k = _hmac(k, SERVICE)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()

    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}")
    return headers


def encode_event(event_type: str, payload: Dict[str, Any]) -> bytes:
    """One AWS eventstream frame (used by tests and as format doc).

    Frame layout (all integers big-endian):
      u32 total_length | u32 headers_length | u32 crc32(prev 8 bytes)
      headers: (u8 name_len, name, u8 value_type=7, u16 len, utf-8 value)*
      payload bytes
      u32 crc32(everything before this trailer)
    """
    headers = b""
    for name, value in ((":message-type", "event"),
                        (":event-type", event_type),
                        (":content-type", "application/json")):
        nb, vb = name.encode(), value.encode()
        headers += struct.pack(">B", len(nb)) + nb
        headers += struct.pack(">BH", 7, len(vb)) + vb
    body = json.dumps(payload).encode()
    total = 12 + len(headers) + len(body) + 4
    prelude = struct.pack(">II", total, len(headers))
    prelude += struct.pack(">I", zlib.crc32(prelude))
    msg = prelude + headers + body
    return msg + struct.pack(">I", zlib.crc32(msg))


def parse_eventstream(buf: bytes) -> Tuple[List[Tuple[str, Dict[str, Any]]], bytes]:
    """Parse complete frames from `buf`; return (events, unconsumed tail).

    Events are (event_type, payload-dict). CRC mismatches raise —
    a corrupted stream must not be silently reassembled.
    """
    events: List[Tuple[str, Dict[str, Any]]] = []
    while len(buf) >= 16:
        total, hlen = struct.unpack(">II", buf[:8])
        if len(buf) < total:
            break
        (pcrc,) = struct.unpack(">I", buf[8:12])
        if zlib.crc32(buf[:8]) != pcrc:
            raise ValueError("eventstream prelude CRC mismatch")
        (mcrc,) = struct.unpack(">I", buf[total - 4: total])
        if zlib.crc32(buf[: total - 4]) != mcrc:
            raise ValueError("eventstream message CRC mismatch")
        # headers: only string (type 7) values appear on this API
        hdrs: Dict[str, str] = {}
        pos, end = 12, 12 + hlen
        while pos < end:
            nlen = buf[pos]; pos += 1
            name = buf[pos: pos + nlen].decode(); pos += nlen
            vtype = buf[pos]; pos += 1
            if vtype == 7:
                (vlen,) = struct.unpack(">H", buf[pos: pos + 2]); pos += 2
                hdrs[name] = buf[pos: pos + vlen].decode(); pos += vlen
            elif vtype in (0, 1):  # bool true/false — no value bytes
                hdrs[name] = str(vtype == 0)
            else:  # fixed-width numerics we never expect; skip conservatively
                width = {2: 1, 3: 2, 4: 4, 5: 8, 8: 8}.get(vtype)
                if width is None:
                    raise ValueError(f"unsupported header type {vtype}")
                pos += width
        payload = buf[end: total - 4]
        data = json.loads(payload) if payload else {}
        kind = hdrs.get(":event-type") or hdrs.get(":exception-type", "")
        if hdrs.get(":message-type") == "exception":
            raise RuntimeError(f"bedrock stream exception {kind}: {data}")
        events.append((kind, data))
        buf = buf[total:]
    return events, buf


def to_converse(
    messages: Sequence[Any],
    tools: Optional[Sequence[Dict[str, Any]]] = None,
    params: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """OpenAI-style ChatMessages -> Converse request body."""
    system: List[Dict[str, str]] = []
    turns: List[Dict[str, Any]] = []
    for m in messages:
        if m.role == "system":
            system.append({"text": m.content})
        elif m.role == "tool":
            turns.append({"role": "user", "content": [{
                "toolResult": {
                    "toolUseId": m.tool_call_id or "call_0",
                    "content": [{"text": m.content}],
                }}]})
        elif m.role == "assistant" and m.tool_calls:
            content: List[Dict[str, Any]] = []
            if m.content:
                content.append({"text": m.content})
            for c in m.tool_calls:
                fn = c.get("function", {})
                try:
                    args = json.loads(fn.get("arguments") or "{}")
                except json.JSONDecodeError:
                    args = {"raw": fn.get("arguments")}
                content.append({"toolUse": {
                    "toolUseId": c.get("id", "call_0"),
                    "name": fn.get("name", ""),
                    "input": args,
                }})
            turns.append({"role": "assistant", "content": content})
        else:
            turns.append({"role": m.role,
                          "content": [{"text": m.content or ""}]})

    # Converse enforces strictly alternating user/assistant roles —
    # merge consecutive same-role turns (multiple toolResults, or a
    # schema instruction appended after the user prompt) into one turn.
    merged: List[Dict[str, Any]] = []
    for t in turns:
        if merged and merged[-1]["role"] == t["role"]:
            merged[-1]["content"].extend(t["content"])
        else:
            merged.append(t)

    body: Dict[str, Any] = {"messages": merged}
    if system:
        body["system"] = system
    p = params or {}
    cfg = {}
    if "max_tokens" in p:
        cfg["maxTokens"] = p["max_tokens"]
    if "temperature" in p:
        cfg["temperature"] = p["temperature"]
    if "top_p" in p:
        cfg["topP"] = p["top_p"]
    if "stop" in p:
        cfg["stopSequences"] = (
            p["stop"] if isinstance(p["stop"], list) else [p["stop"]])
    if cfg:
        body["inferenceConfig"] = cfg
    if tools:
        body["toolConfig"] = {"tools": [{
            "toolSpec": {
                "name": t["function"]["name"],
                "description": t["function"].get("description", ""),
                "inputSchema": {"json": t["function"].get(
                    "parameters", {"type": "object"})},
            }} for t in tools]}
    return body


def from_converse(data: Dict[str, Any]) -> Tuple[str, List[Dict[str, Any]], Dict[str, int]]:
    """Converse response -> (content, openai-style tool_calls, usage)."""
    msg = (data.get("output") or {}).get("message") or {}
    text_parts: List[str] = []
    tool_calls: List[Dict[str, Any]] = []
    for block in msg.get("content") or []:
        if "text" in block:
            text_parts.append(block["text"])
        elif "toolUse" in block:
            tu = block["toolUse"]
            tool_calls.append({
                "id": tu.get("toolUseId", "call_0"),
                "type": "function",
                "function": {
                    "name": tu.get("name", ""),
                    "arguments": json.dumps(tu.get("input") or {}),
                },
            })
    u = data.get("usage") or {}
    usage = {k2: u[k1] for k1, k2 in (
        ("inputTokens", "prompt_tokens"),
        ("outputTokens", "completion_tokens"),
        ("totalTokens", "total_tokens")) if k1 in u}
    return "".join(text_parts), tool_calls, usage


class BedrockClient:
    """Minimal async Converse caller with injectable transport."""

    def __init__(self, *, model: str, region: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 session_token: Optional[str] = None,
                 timeout: float = 120.0,
                 transport: Optional[Callable[..., Awaitable[Dict[str, Any]]]] = None,
                 stream_transport: Optional[Callable[..., AsyncIterator[bytes]]] = None):
        self.model = model
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN")
        self.timeout = timeout
        self._transport = transport
        self._stream_transport = stream_transport

    @property
    def endpoint(self) -> str:
        model_q = urllib.parse.quote(self.model, safe="")
        return (f"https://bedrock-runtime.{self.region}.amazonaws.com"
                f"/model/{model_q}/converse")

    async def converse(self, messages: Sequence[Any], *,
                       tools: Optional[Sequence[Dict[str, Any]]] = None,
                       **params: Any) -> Dict[str, Any]:
        body = json.dumps(to_converse(messages, tools, params)).encode()
        headers = sign_request(
            method="POST", url=self.endpoint, body=body,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, session_token=self.session_token)
        if self._transport is not None:
            return await self._transport(url=self.endpoint, body=body,
                                         headers=headers)
        import httpx

        async with httpx.AsyncClient(timeout=self.timeout) as client:
            r = await client.post(self.endpoint, content=body, headers=headers)
            r.raise_for_status()
            return r.json()

    @property
    def stream_endpoint(self) -> str:
        model_q = urllib.parse.quote(self.model, safe="")
        return (f"https://bedrock-runtime.{self.region}.amazonaws.com"
                f"/model/{model_q}/converse-stream")

    async def converse_stream(
        self, messages: Sequence[Any], *,
        tools: Optional[Sequence[Dict[str, Any]]] = None,
        **params: Any,
    ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        """Yield (event_type, payload) ConverseStream events as they
        arrive: messageStart, contentBlockDelta (payload["delta"]["text"]
        or ["toolUse"]), contentBlockStop, messageStop, metadata."""
        body = json.dumps(to_converse(messages, tools, params)).encode()
        headers = sign_request(
            method="POST", url=self.stream_endpoint, body=body,
            access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, session_token=self.session_token)
        buf = b""
        if self._stream_transport is not None:
            async for chunk in self._stream_transport(
                    url=self.stream_endpoint, body=body, headers=headers):
                events, buf = parse_eventstream(buf + chunk)
                for ev in events:
                    yield ev
            return
        import httpx

        async with httpx.AsyncClient(timeout=self.timeout) as client:
            async with client.stream("POST", self.stream_endpoint,
                                     content=body, headers=headers) as r:
                r.raise_for_status()
                async for chunk in r.aiter_bytes():
                    events, buf = parse_eventstream(buf + chunk)
                    for ev in events:
                        yield ev
