"""The host-only LLM modules the port copies: `llm/bedrock.py` (SigV4, the
eventstream codec, Converse mapping, `BedrockClient`), `llm/provision.py`
(`GGUFProvisioner`), `llm/vlm.py` (`VLMProcessor`), and the router's
live `Provider.BEDROCK`, against the JAX package's, on the CPU.

Each copy is its source verbatim below the header naming it, and the
router is the reference's but for its header, a comment and one error
message. Every test of tests/test_bedrock.py and tests/test_provision.py
runs again with its names bound to the port's modules; and the same
calls in both packages (with the fake transports and services those
tests use: nothing reaches a network) give equal results: the same
signed headers at a fixed time, request bodies, parsed frames, errors,
uploads and registrations.
"""

import ast
import asyncio
import datetime
import importlib
import json
import os
import re
import types

import pytest

import test_bedrock
import test_provision

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ["llm.bedrock", "llm.provision", "llm.vlm"]


def pair(name):
    return (importlib.import_module(f"rag_application_tpu.{name}"),
            importlib.import_module(f"rag_application_tpu_torch.{name}"))


def body(source):
    doc = ast.parse(source).body[0]
    return "\n".join(source.split("\n")[doc.end_lineno:])


def read(pkg, path):
    with open(os.path.join(_REPO, pkg, path)) as f:
        return f.read()


@pytest.mark.parametrize("name", COPIED)
def test_copy_is_verbatim(name):
    path = name.replace(".", "/") + ".py"
    src, copy = read("rag_application_tpu", path), read(
        "rag_application_tpu_torch", path)
    assert f"Copy of `rag_application_tpu/{path}`" in copy
    assert body(copy) == body(src)
    assert not re.search(r"^\s*(from|import) (jax|flax|rag_application_tpu)\b",
                         copy, re.M)


def test_router_is_the_reference_but_local_notes():
    src = body(read("rag_application_tpu", "llm/router.py")).split("\n")
    copy = body(read("rag_application_tpu_torch", "llm/router.py")).split(
        "\n")
    assert len(src) == len(copy)
    differ = [(a, b) for a, b in zip(src, copy) if a != b]
    assert differ == [
        ("    # on-device generation: the XLA decoder in models/decoder.py "
         "served",
         "    # on-device generation: the decoder in models/decoder.py served"),
        ('                "with LocalLLM.from_hf_dir(checkpoint_dir) '
         '(llm/local.py)")',
         '                "from decoder params, a config and a tokenizer '
         '(llm/local.py)")')]


# ------------------------------- the reference's tests, on the port's names

def rebound(fn, module):
    """``fn`` (a test of ``module``) with the module's imported names
    bound to the port's modules of the same name."""
    names = dict(fn.__globals__)
    for key, value in vars(module).items():
        src = getattr(value, "__module__", None) or (
            value.__name__ if isinstance(value, types.ModuleType) else None)
        if src and src.startswith("rag_application_tpu."):
            port = importlib.import_module(
                "rag_application_tpu_torch." + src.split(".", 1)[1])
            names[key] = getattr(port, key, None) or getattr(
                port, getattr(value, "__name__", key))
    # the module's own helpers (e.g. test_provision.make) see them too
    for key, value in vars(module).items():
        if (isinstance(value, types.FunctionType)
                and value.__module__ == module.__name__):
            names[key] = types.FunctionType(value.__code__, names, key,
                                            value.__defaults__,
                                            value.__closure__)
    return names[fn.__name__]


def reference_tests(module):
    return [n for n in dir(module) if n.startswith("test_")]


@pytest.mark.parametrize("name", reference_tests(test_bedrock))
def test_bedrock_case_on_the_port(name):
    fn = rebound(getattr(test_bedrock, name), test_bedrock)
    assert fn.__globals__["LLMRouter"].__module__ == \
        "rag_application_tpu_torch.llm.router"
    fn()


@pytest.mark.parametrize("name", reference_tests(test_provision))
def test_provision_case_on_the_port(name):
    fn = rebound(getattr(test_provision, name), test_provision)
    assert fn.__globals__["GGUFProvisioner"].__module__ == \
        "rag_application_tpu_torch.llm.provision"
    fn()


# ---------------------------------------------- equal results, both sides

NOW = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("kw", [
    dict(method="POST", body=b'{"messages":[]}',
         url="https://bedrock-runtime.us-east-1.amazonaws.com/model/m/converse",
         access_key="AKIDEXAMPLE",
         secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
         region="us-east-1"),
    dict(method="POST", body=b"{}", session_token="TOKEN",
         url="https://bedrock-runtime.eu-west-1.amazonaws.com/model/x/"
             "converse-stream?a=1&b=two%20words",
         access_key="AK", secret_key="SK", region="eu-west-1"),
])
def test_sign_request_equal(kw):
    j, t = pair("llm.bedrock")
    assert t.sign_request(now=NOW, **kw) == j.sign_request(now=NOW, **kw)


def converse_messages(router):
    C = router.ChatMessage
    return [
        C("system", "be brief"), C("user", "question"),
        C("user", "Respond with ONLY valid JSON"),
        C("assistant", "checking", tool_calls=[
            {"id": "a", "type": "function",
             "function": {"name": "t1", "arguments": json.dumps({"q": 1})}},
            {"id": "b", "type": "function",
             "function": {"name": "t2", "arguments": "{}"}}]),
        C("tool", "r1", tool_call_id="a"), C("tool", "r2", tool_call_id="b"),
        C("user", [{"type": "text", "text": "look"},
                   {"type": "image_url",
                    "image_url": {"url": "data:image/png;base64,AAAA"}}]),
    ]


def test_converse_mapping_equal():
    (jb, tb), (jr, tr) = pair("llm.bedrock"), pair("llm.router")
    tools = [{"type": "function", "function": {
        "name": "lookup", "description": "d",
        "parameters": {"type": "object",
                       "properties": {"q": {"type": "string"}}}}}]
    params = {"max_tokens": 64, "temperature": 0.1, "stop": "END",
              "top_p": 0.5}
    assert outcome(tb.to_converse, converse_messages(tr), tools, params) == \
        outcome(jb.to_converse, converse_messages(jr), tools, params)
    data = {"output": {"message": {"content": [
        {"text": "the answer"}, {"text": " more"},
        {"toolUse": {"toolUseId": "t9", "name": "lookup",
                     "input": {"q": "y"}}}]}},
        "usage": {"inputTokens": 10, "outputTokens": 5, "totalTokens": 15}}
    for d in (data, {"output": {}}, {}):
        assert outcome(tb.from_converse, d) == outcome(jb.from_converse, d)


def test_eventstream_codec_equal():
    jb, tb = pair("llm.bedrock")
    payloads = [("messageStart", {"role": "assistant"}),
                ("contentBlockDelta", {"delta": {"text": "héllo"}}),
                ("messageStop", {"stopReason": "end_turn"})]
    frames = [tb.encode_event(k, p) for k, p in payloads]
    assert frames == [jb.encode_event(k, p) for k, p in payloads]
    stream = b"".join(frames)
    for cut in (0, 5, len(frames[0]), len(stream) - 3, len(stream)):
        assert outcome(tb.parse_eventstream, stream[:cut]) == \
            outcome(jb.parse_eventstream, stream[:cut])
    bad = bytearray(stream)
    bad[20] ^= 0xFF
    assert outcome(tb.parse_eventstream, bytes(bad)) == \
        outcome(jb.parse_eventstream, bytes(bad))


def bedrock_run(root):
    """The router's Bedrock chat, structured output and stream through a
    fake transport; returns what the transport saw and what came back."""
    router = importlib.import_module(f"{root}.llm.router")
    bedrock = importlib.import_module(f"{root}.llm.bedrock")
    seen = []

    async def transport(url, body, headers):
        seen.append((url, json.loads(body), sorted(headers)))
        text = "hello" if len(seen) == 1 else '{"a": 1}'
        return {"output": {"message": {"content": [{"text": text}]}},
                "usage": {"totalTokens": 3}}

    frames = b"".join(bedrock.encode_event(k, p) for k, p in (
        ("contentBlockDelta", {"delta": {"text": "hel"}}),
        ("contentBlockDelta", {"delta": {"toolUse": {"input": "{}"}}}),
        ("contentBlockDelta", {"delta": {"text": "lo!"}})))

    async def stream_transport(url, body, headers):
        seen.append((url, json.loads(body), sorted(headers)))
        for i in range(0, len(frames), 5):
            yield frames[i:i + 5]

    async def main():
        r = router.LLMRouter(router.Provider.BEDROCK,
                             model="meta.llama3-8b-instruct-v1:0")
        c = r._bedrock
        c._transport, c._stream_transport = transport, stream_transport
        c.access_key, c.secret_key, c.region = "AK", "SK", "us-west-2"
        M = router.ChatMessage
        resp = await r.chat([M("system", "s"), M("user", "ping")],
                            temperature=0.2, seed=7)
        out = await r.generate_structured(
            "give json", {"type": "object",
                          "properties": {"a": {"type": "integer"}}})
        chunks = [x async for x in r.stream([M("user", "ping")],
                                            max_tokens=9)]
        return [resp.content, resp.tool_calls, resp.usage, out, chunks]

    return asyncio.run(main()), seen


def test_router_bedrock_equal():
    assert bedrock_run("rag_application_tpu_torch") == \
        bedrock_run("rag_application_tpu")


def provision_run(root, **svc_kw):
    provision = importlib.import_module(f"{root}.llm.provision")
    svc = test_provision.FakeServices(**svc_kw)
    name = svc_kw.pop("model", "my-model")
    cfg = provision.GGUFProvisionConfig(hf_repo="org/model",
                                        poll_interval_s=0.0)
    prov = provision.GGUFProvisioner(name, cfg, client_factory=svc)
    got = outcome(lambda: asyncio.run(prov.ensure_model_available()))
    return [got, svc.blobs, svc.created, svc.polls, svc.registered]


@pytest.mark.parametrize("svc_kw", [
    {}, {"registered": ["my-model"]}, {"fail_convert": True},
    {"polls_until_done": 4}, {"registered": ["other"]}])
def test_provision_equal(svc_kw):
    assert provision_run("rag_application_tpu_torch", **dict(svc_kw)) == \
        provision_run("rag_application_tpu", **dict(svc_kw))


def vlm_run(root):
    router = importlib.import_module(f"{root}.llm.router")
    vlm = importlib.import_module(f"{root}.llm.vlm")
    llm = router.LLMRouter(router.Provider.STUB)
    llm.stub.on(r"Describe this image", lambda p: f"a figure ({len(p)})")
    proc = vlm.VLMProcessor(llm, cache_size=2)
    msgs = [{"role": "system", "content": "plain"},
            {"role": "user", "content": [
                {"type": "text", "text": "what is this"},
                {"type": "image_url", "image_url": {"url": "QUJD"}},
                {"type": "image_url", "image_url": "https://x/y.png"},
                {"type": "image", "data": "QUJD"}, "raw"]}]

    async def main():
        a = await proc.process_messages(msgs)
        b = [await proc.describe(x) for x in ("Z", "QUJD", "W", "QUJD")]
        return [a, b, proc.calls, list(proc._cache)]

    return asyncio.run(main())


def test_vlm_equal():
    assert vlm_run("rag_application_tpu_torch") == vlm_run(
        "rag_application_tpu")
