"""The agent layer (`agents/*`) against the JAX reference's, on the CPU.

Every case of tests/test_agents.py and tests/test_deep_research.py (and
the agent case of tests/test_ann_integration.py) runs as one scenario in
each package: the same STUB router rules, tools and inputs, and memory
stores whose embedders carry the same weights (the flax weights through
`state.encoder_params_from_jax`). A scenario returns what a user of the
agents sees: the turns' contents, messages and tool calls, summaries,
token usage, the checkpointed states, streamed events, and the memory
stores' contents (values without their `_updated` time, search hits
with scores within 1e-5). Both packages must return the same record; the
port must also pass each case's own assertions. Checkpoint ids are
random in both, so the states they name are compared instead.

The port's `VectorMemoryStore` puts its indexes on its embedder's
device or the `device=` given; that is checked apart.
"""

import asyncio
import functools
import importlib
import json
import types

import jax
import numpy as np
import pytest

from rag_application_tpu.config import EncoderConfig as JEncoderConfig
from rag_application_tpu.models.embedder import Embedder as JEmbedder
from rag_application_tpu.models.encoder import init_encoder as j_init
from rag_application_tpu_torch import state
from rag_application_tpu_torch.config import EncoderConfig
from rag_application_tpu_torch.models.embedder import Embedder
from rag_application_tpu_torch.models.encoder import init_encoder

ECFG = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_len=32, out_dim=32, dtype="float32")
COPIED = ["agents.base_agent", "agents.chat_agent", "agents.waiter_agent",
          "agents.deep_research", "tools.browser"]


@functools.lru_cache(maxsize=None)
def embedders():
    js = j_init(JEncoderConfig(**ECFG), max_len=16, seed=3)
    cfg = EncoderConfig(**ECFG)
    ts = init_encoder(cfg, device="cpu")
    ts.model.load_state_dict(state.encoder_params_from_jax(
        jax.tree.map(np.asarray, js.params), cfg, "cpu"))
    return (JEmbedder(js, batch_size=4, max_len=16),
            Embedder(ts, batch_size=4, max_len=16))


def package(root):
    """The names a scenario uses, from one package."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    router, memory = mod("llm.router"), mod("agents.memory")
    reg = mod("tools.registry")
    agents = mod("agents")
    return types.SimpleNamespace(
        LLMRouter=router.LLMRouter, Provider=router.Provider,
        ChatMessage=router.ChatMessage,
        BaseAgent=mod("agents.base_agent").BaseAgent,
        AgentState=mod("agents.base_agent").AgentState,
        VectorMemoryStore=memory.VectorMemoryStore,
        ThreadCheckpointer=memory.ThreadCheckpointer,
        Tool=reg.Tool, ToolRegistry=reg.ToolRegistry, tool=reg.tool,
        DeepResearchAgent=mod("agents.deep_research").DeepResearchAgent,
        chat=mod("agents.chat_agent"), waiter=mod("agents.waiter_agent"),
        agents=agents,
        emb=embedders()[0 if root == "rag_application_tpu" else 1])


JAX = "rag_application_tpu"
PORT = "rag_application_tpu_torch"


def strip(x):
    """A record without what is random or a clock in both packages."""
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items()
                if k not in ("_updated", "checkpoint_id", "ts", "updated_at")}
    if isinstance(x, (list, tuple)):
        return [strip(v) for v in x]
    return x


def assert_same(got, want, path="$"):
    """Equal records, floats within 1e-5."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= 1e-5, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def store_contents(store):
    return {" / ".join(ns): strip(list(sp["values"].values()))
            for ns, sp in store._spaces.items()}


def turn(out):
    return strip({k: out[k] for k in ("content", "messages", "summary",
                                      "token_usage_history")})


# ---------------------------------------------------------------- scenarios

def stub_llm_echo_and_rules(P):
    async def main():
        r = P.LLMRouter(P.Provider.STUB)
        a = await r.generate_text("hello there")
        r.stub.on(r"capital of france", lambda _: "Paris")
        b = await r.generate_text("What is the Capital of France?")
        assert "hello there" in a and b == "Paris"
        return [a, b]
    return asyncio.run(main())


def stub_llm_structured_output(P):
    async def main():
        r = P.LLMRouter(P.Provider.STUB)
        schema = {"type": "object", "properties": {
            "name": {"type": "string"}, "count": {"type": "integer"},
            "tags": {"type": "array"}}}
        out = await r.generate_structured("extract", schema)
        assert "name" in out and out["tags"] == []
        return out
    return asyncio.run(main())


def stub_llm_tool_call(P):
    async def main():
        r = P.LLMRouter(P.Provider.STUB)
        tools = [{"type": "function", "function": {"name": "lookup",
                  "description": "", "parameters": {}}}]
        resp = await r.chat([P.ChatMessage("user", "please use lookup now")],
                            tools=tools)
        assert resp.tool_calls[0]["function"]["name"] == "lookup"
        return [resp.content, resp.tool_calls, resp.usage]
    return asyncio.run(main())


def llm_stream(P):
    async def main():
        r = P.LLMRouter(P.Provider.STUB)
        chunks = [c async for c in r.stream([P.ChatMessage("user",
                                                           "x" * 100)])]
        assert len(chunks) > 1 and "".join(chunks).startswith("[stub]")
        return chunks
    return asyncio.run(main())


def tool_decorator_schema(P):
    @P.tool("adder", "adds numbers")
    def adder(a: int, b: int = 2):
        return a + b

    assert adder.schema["required"] == ["a"]
    return [adder.schema, asyncio.run(adder.call(a=3))]


def registry_executes_openai_calls(P):
    async def main():
        reg = P.ToolRegistry([P.Tool("echo", "", {"type": "object",
                                                  "properties": {}},
                                     lambda **kw: {"echoed": kw})])
        a = await reg.execute_call({
            "id": "c1", "type": "function",
            "function": {"name": "echo", "arguments": '{"x": 1}'}})
        b = await reg.execute_call({
            "id": "c2", "function": {"name": "nope", "arguments": "{}"}})
        assert "unknown tool" in b["content"]
        return [a, b]
    return asyncio.run(main())


def vector_memory_store(P):
    store = P.VectorMemoryStore(P.emb)
    ns = ("memory", "u1", "semantic")
    store.put(ns, "k1", {"fact": "vivek likes tpus"}, text="vivek likes tpus")
    store.put(ns, "k2", {"fact": "the sky is blue"}, text="the sky is blue")
    got = [store.get(ns, "k1"), store.search(ns, "vivek likes tpus", k=1),
           store.search(ns, "blue sky", k=4)]
    assert got[1][0]["fact"] == "vivek likes tpus"
    store.put(ns, "k1", {"fact": "updated"}, text="updated fact")
    assert store.get(ns, "k1")["fact"] == "updated"
    store.delete(ns, "k2")
    assert store.get(ns, "k2") is None
    got += [store.list(ns), store.search(ns, "updated", k=3),
            store.search(("other",), "x"), store_contents(store)]
    return strip(got)


def memory_store_compacts(P):
    """A key put again and again: tombstones pile up until compaction
    rebuilds the index from the live vectors (the 'profile' key path)."""
    store = P.VectorMemoryStore(P.emb)
    ns = ("memory", "u2", "profile")
    for i in range(70):
        store.put(ns, "profile", {"facts": [f"fact {i}"]},
                  text=f"the profile now holds fact {i}")
        store.put(ns, f"k{i % 3}", {"n": i}, text=f"note {i}")
    sp = store._spaces[ns]
    return strip([sp["rows"], sp["dead"], sp["index"].size,
                  store.search(ns, "fact 69", k=4), store_contents(store)])


def checkpointer_roundtrip(P, tmp_path):
    cp = P.ThreadCheckpointer(str(tmp_path))
    c1 = cp.save("thread-1", {"messages": [1]})
    c2 = cp.save("thread-1", {"messages": [1, 2]})
    assert cp.list_checkpoints("thread-1") == [c1, c2]
    cp.save("chat-2", {"messages": [{"role": "user", "content": "hi"},
                                    {"role": "assistant", "content": "yo"}]})
    out = [cp.load("thread-1"), cp.load("thread-1", c1), cp.load("missing"),
           len(cp.list_checkpoints("thread-1")), cp.thread_messages("chat-2")]
    cp.drop_thread("thread-1")
    out.append(strip(cp.list_threads()))
    return out + [cp.load("thread-1")]


def agent_basic_invoke(P):
    async def main():
        agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB))
        out = await agent.ainvoke("say something", thread_id="t1")
        out2 = await agent.ainvoke("again", thread_id="t1")
        assert len(out2["messages"]) == 4
        return [turn(out), turn(out2), agent.checkpointer.load("t1")]
    return asyncio.run(main())


def agent_tool_loop(P):
    async def main():
        calls = []

        def weather(query: str = ""):
            calls.append(query)
            return {"forecast": "sunny"}

        agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB), tools=[
            P.Tool("weather", "get weather",
                   {"type": "object",
                    "properties": {"query": {"type": "string"}}}, weather)])
        out = await agent.ainvoke("please use weather today", thread_id="w")
        assert calls and "tool" in [m["role"] for m in out["messages"]]
        return [turn(out), calls, agent.checkpointer.load("w")]
    return asyncio.run(main())


def agent_summarization_node(P):
    async def main():
        agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB), max_tokens=100,
                            target_tokens=40)
        agent.llm.stub.on(r"summarize", lambda _: "the-summary")
        st = P.AgentState(messages=[
            {"role": "user", "content": "x" * 300},
            {"role": "assistant", "content": "y" * 300},
            {"role": "user", "content": "latest question"}])
        await agent._summarization_node(st)
        assert st.summary == "the-summary" and len(st.messages) < 3
        return st.to_dict()
    return asyncio.run(main())


def agent_checkpoint_resume(P, tmp_path):
    async def main():
        cp = P.ThreadCheckpointer(str(tmp_path))
        a1 = P.BaseAgent(P.LLMRouter(P.Provider.STUB), checkpointer=cp)
        first = await a1.ainvoke("remember the number 42", thread_id="t9")
        a2 = P.BaseAgent(P.LLMRouter(P.Provider.STUB), checkpointer=cp)
        out = await a2.ainvoke("continue", thread_id="t9")
        assert any("42" in str(m.get("content")) for m in out["messages"])
        # resume from the first turn's checkpoint id: a branch
        branch = await a2.ainvoke("branch", thread_id="t9",
                                  checkpoint_id=first["checkpoint_id"])
        return [turn(first), turn(out), turn(branch), cp.load("t9"),
                len(cp.list_checkpoints("t9"))]
    return asyncio.run(main())


def agent_stream_events(P):
    async def main():
        agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB))
        events = [e async for e in agent.astream("stream me",
                                                 thread_id="s")]
        assert events[-1]["type"] == "done"
        assert "stream me" in "".join(e.get("delta", "") for e in events)
        return [strip(events), agent.checkpointer.load("s")]
    return asyncio.run(main())


def agent_stream_with_tools(P):
    async def main():
        agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB), tools=[
            P.Tool("lookup", "", {"type": "object", "properties": {}},
                   lambda query="": {"hit": query[:12]})], max_tool_rounds=2)
        events = [e async for e in agent.astream("please use lookup x",
                                                 thread_id="st")]
        return [strip(events), agent.checkpointer.load("st")]
    return asyncio.run(main())


REFLECTION = {
    "semantic": [{"subject": "user", "predicate": "likes",
                  "object": "tpus"}],
    "profile_facts": ["likes tpus"],
    "episode": {"observation": "o", "thoughts": "t", "action": "a",
                "result": "r"},
    "procedures": [{"name": "answer style",
                    "conditions": "user asks for code",
                    "steps": ["reply with bullet points"]}]}


def agent_reflections(P):
    async def main():
        store = P.VectorMemoryStore(P.emb)
        llm = P.LLMRouter(P.Provider.STUB)
        llm.stub.on(r"extract memories", lambda _: json.dumps(REFLECTION))
        agent = P.BaseAgent(llm, memory_store=store, reflections=True,
                            user_id="u7")
        out = await agent.ainvoke("i like tpus", thread_id="r1")
        await agent.drain_reflections()
        assert store.list(("memory", "u7", "profile"))[-1]["facts"] == \
            ["likes tpus"]
        # a second turn reads the memories back into its precontext
        out2 = await agent.ainvoke("what do i like", thread_id="r1")
        await agent.drain_reflections()
        hits = store.search(("memory", "u7", "semantic"), "tpus", k=2)
        return [turn(out), turn(out2), store_contents(store), strip(hits)]
    return asyncio.run(main())


def streamed_turns_reflect_too(P):
    async def main():
        store = P.VectorMemoryStore(P.emb)
        llm = P.LLMRouter(P.Provider.STUB)
        llm.stub.on(r"extract memories", lambda _: json.dumps({
            "semantic": [], "profile_facts": [], "episode": {},
            "procedures": [
                {"name": "", "conditions": "asks for code",
                 "steps": ["bullets"]},
                {"name": "", "conditions": "asks for math",
                 "steps": ["latex"]}]}))
        agent = P.BaseAgent(llm, memory_store=store, reflections=True,
                            user_id="u8")
        async for _ in agent.astream("hello", thread_id="s1"):
            pass
        await agent.drain_reflections()
        assert len(store.list(("memory", "u8", "procedural"))) == 2
        assert agent._reflection_tasks == []
        return store_contents(store)
    return asyncio.run(main())


def procedural_correction_changes_precontext(P):
    async def main():
        store = P.VectorMemoryStore(P.emb)
        llm = P.LLMRouter(P.Provider.STUB)
        llm.stub.on(r"extract memories", lambda _: json.dumps({
            "procedures": [{"name": "citation rule",
                            "conditions": "any summary request",
                            "steps": ["always cite the source document"]}]}))
        agent = P.BaseAgent(llm, memory_store=store, reflections=True,
                            user_id="u8")
        ask = [{"role": "user", "content": "summarize the report"}]
        before = agent._precontext(P.AgentState(messages=list(ask)))
        assert "citation rule" not in before
        await agent.ainvoke("please always cite the source document",
                            thread_id="c1")
        await agent.drain_reflections()
        pre = agent._precontext(P.AgentState(messages=list(ask)))
        assert "citation rule" in pre and "cite the source" in pre
        # the precontext without its clock line, memories parsed (their
        # search scores are floats)
        out = []
        for line in pre.split("\n\n"):
            if line.startswith("Current UTC time"):
                continue
            head, _, rest = line.partition(": ")
            if head in ("User profile", "Relevant procedures",
                        "Relevant memories"):
                out.append([head, json.loads(rest)])
            else:
                out.append(line)
        return out
    return asyncio.run(main())


def checkpoints_are_snapshots(P):
    cp = P.ThreadCheckpointer()
    st = {"messages": [{"role": "user", "content": "one"}], "summary": ""}
    a = cp.save("t", st)
    st["messages"].append({"role": "assistant", "content": "two"})
    cp.save("t", st)
    restored = cp.load("t", checkpoint_id=a)
    assert len(restored["messages"]) == 1
    restored["messages"].append({"role": "user", "content": "x"})
    return [cp.load("t", checkpoint_id=a), cp.load("t")]


def summarization_never_orphans_tool_messages(P):
    agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB), max_tokens=60,
                        target_tokens=30)
    msgs = [{"role": "user", "content": "question " * 20},
            {"role": "assistant", "content": "calling tools",
             "tool_calls": [{"id": "1"}]},
            {"role": "tool", "content": "result " * 20},
            {"role": "tool", "content": "result " * 20},
            {"role": "assistant", "content": "final answer " * 5}]
    st = P.AgentState(messages=list(msgs))
    asyncio.run(agent._summarization_node(st))
    assert st.messages and st.messages[0].get("role") != "tool"
    return st.to_dict()


def agent_registry_lists_all_builtins(P):
    assert P.agents.get_agent_by_id("waiter_agent") is not None
    names = {"chat_agent", "deep_research_agent", "waiter_agent",
             "knowledge_search_agent"}
    assert names <= set(P.agents.AGENT_CLASS_MAP)
    return {n: P.agents.get_agent_by_id(n).__name__ for n in sorted(names)}


def agent_abatch_and_events(P):
    async def main():
        agent = P.BaseAgent(P.LLMRouter(P.Provider.STUB))
        outs = await agent.abatch(["one", "two"])
        assert len(outs) == 2 and all(o["content"] for o in outs)
        events = [e async for e in agent.astream_events("hello",
                                                        thread_id="e")]
        assert events[-1]["event"] == "on_end"
        return [[turn(o) for o in outs], strip(events)]
    return asyncio.run(main())


def chat_agent_delegates(P):
    """ChatAgent with the knowledge agent bound as a tool: the outer
    turn calls it, the scratch sub-thread is dropped."""
    async def main():
        searched = []
        toolbox = P.ToolRegistry([P.Tool(
            "hybrid_search", "", {"type": "object", "properties": {}},
            lambda query="", k=5: searched.append(query) or
            [{"text": "a doc"}])])
        agent = P.chat.ChatAgent(P.LLMRouter(P.Provider.STUB),
                                 knowledge_toolbox=toolbox)
        out = await agent.ainvoke("please use knowledge_search_agent now",
                                  thread_id="chat")
        ks = P.chat.KnowledgeSearchAgent(P.LLMRouter(P.Provider.STUB),
                                         toolbox=toolbox)
        out2 = await ks.ainvoke("use hybrid_search for x", thread_id="ks")
        return [turn(out), turn(out2), searched,
                sorted(t["thread_id"]
                       for t in agent.checkpointer.list_threads()),
                agent.tools.specs(), ks.tools.specs()]
    return asyncio.run(main())


def waiter_agent_orders(P):
    async def main():
        agent = P.waiter.WaiterAgent(P.LLMRouter(P.Provider.STUB))
        tools = {n: agent.tools.get(n) for n in agent.tools.names()}
        out = [await tools["browse_menu"].call(category="Mains"),
               await tools["add_to_order"].call(table="7",
                                                dish="Tiramisu",
                                                quantity=2),
               await tools["add_to_order"].call(table="7", dish="sushi"),
               await tools["get_order"].call(table="7"),
               await tools["remove_from_order"].call(table="9",
                                                     dish="tiramisu"),
               await tools["checkout"].call(table="7")]
        turn_ = await agent.ainvoke("please use browse_menu", thread_id="w")
        return out + [turn(turn_), agent.tools.specs()]
    return asyncio.run(main())


def research_setup(P):
    store = P.VectorMemoryStore(P.emb)
    llm = P.LLMRouter(P.Provider.STUB)
    gap_state = {"round": 0}

    def gap(_):
        gap_state["round"] += 1
        return json.dumps({"gap_exists": gap_state["round"] <= 2,
                           "missing": "details about X"})

    llm.stub.on(r"research contract", lambda _: json.dumps({
        "needs_clarification": False,
        "contract": ["history of X", "uses of X"]}))
    llm.stub.on(r"Does a gap remain", gap)
    llm.stub.on(r"search subqueries", lambda _: json.dumps(
        {"subqueries": ["what is the history of X"]}))
    llm.stub.on(r"Write a dense factual finding",
                lambda _: "X was invented in 1970 and is used for Y.")
    llm.stub.on(r"final research report",
                lambda _: "REPORT: X invented 1970; used for Y.")
    searches = []
    toolbox = P.ToolRegistry([P.Tool(
        "hybrid_search", "", {"type": "object", "properties": {}},
        lambda query, k=4: searches.append(query) or [{"text": "X doc"}])])
    return llm, store, toolbox, searches


def deep_research_full_loop(P):
    llm, store, toolbox, searches = research_setup(P)

    async def main():
        agent = P.DeepResearchAgent(llm, toolbox=toolbox,
                                    research_store=store, max_iterations=3)
        out = await agent.ainvoke("tell me about X", thread_id="dr1")
        assert out["status"] == "complete"
        assert out["content"].startswith("REPORT")
        assert out["trace"][-1]["open_gaps"] == 0 and searches
        findings = store.list(("research", "dr1"))
        assert findings and "1970" in findings[0]["finding"]
        again = await agent.ainvoke("tell me about X", thread_id="dr1",
                                    checkpoint_id=out["checkpoint_id"])
        return [strip(out), strip(again), searches,
                sorted(json.dumps({k: v for k, v in strip(f).items()
                                   if k != "_key"}, sort_keys=True)
                       for f in findings),
                strip(agent.checkpointer.load("dr1"))]
    return asyncio.run(main())


def deep_research_clarification_interrupt(P):
    llm = P.LLMRouter(P.Provider.STUB)
    llm.stub.on(r"research contract", lambda _: json.dumps({
        "needs_clarification": True,
        "clarifying_question": "Which X do you mean?", "contract": []}))

    async def main():
        agent = P.DeepResearchAgent(
            llm, research_store=P.VectorMemoryStore(P.emb), clarify=True,
            max_iterations=1)
        first = await agent.ainvoke("about X", thread_id="dr2")
        assert first["status"] == "needs_clarification"
        llm.stub._rules.clear()
        llm.stub.on(r"research contract", lambda _: json.dumps({
            "needs_clarification": False, "contract": ["item"]}))
        llm.stub.on(r"Does a gap remain",
                    lambda _: json.dumps({"gap_exists": False}))
        llm.stub.on(r"final research report", lambda _: "final")
        out = await agent.ainvoke("about X", thread_id="dr2",
                                  clarification="X the language")
        assert out["status"] == "complete"
        return [strip(first), strip(out)]
    return asyncio.run(main())


SCENARIOS = [stub_llm_echo_and_rules, stub_llm_structured_output,
             stub_llm_tool_call, llm_stream, tool_decorator_schema,
             registry_executes_openai_calls, vector_memory_store,
             memory_store_compacts, agent_basic_invoke, agent_tool_loop,
             agent_summarization_node, agent_stream_events,
             agent_stream_with_tools, agent_reflections,
             streamed_turns_reflect_too,
             procedural_correction_changes_precontext,
             checkpoints_are_snapshots,
             summarization_never_orphans_tool_messages,
             agent_registry_lists_all_builtins, agent_abatch_and_events,
             chat_agent_delegates, waiter_agent_orders,
             deep_research_full_loop, deep_research_clarification_interrupt]
WITH_DIR = [checkpointer_roundtrip, agent_checkpoint_resume]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    want = scenario(package(JAX))
    got = scenario(package(PORT))
    assert_same(got, want)


@pytest.mark.parametrize("scenario", WITH_DIR, ids=lambda f: f.__name__)
def test_disk_scenario_matches_reference(scenario, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = scenario(package(JAX), tmp_path / "j")
    got = scenario(package(PORT), tmp_path / "t")
    assert_same(got, want)


def test_memory_store_device():
    """The store's indexes go on its embedder's device; an embedder that
    names no device means the default one, CUDA, which a machine without
    it refuses."""
    import torch

    from rag_application_tpu_torch.agents.memory import VectorMemoryStore

    _, emb = embedders()
    store = VectorMemoryStore(emb)
    store.put(("a",), "k", {"v": 1}, text="one")
    assert store.device == emb.device == torch.device("cpu")
    assert store._spaces[("a",)]["index"].device == emb.device

    class Plain:
        dim = 32

        def __init__(self, device=None):
            self.device = device

        def encode(self, texts):
            return np.ones((len(texts), 32), np.float32)

    plain = VectorMemoryStore(Plain("cpu"))
    plain.put(("b",), "k", {"v": 2})
    assert plain._spaces[("b",)]["index"].vecs.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VectorMemoryStore(Plain())


@pytest.mark.parametrize("name", COPIED + ["agents"])
def test_copy_is_verbatim(name):
    """The host-only modules are their sources below a header that names
    them (`agents/__init__.py` has no docstring of its own: the port's
    adds one above the source)."""
    import ast
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = name.replace(".", "/") + ("/__init__.py" if name == "agents"
                                     else ".py")

    def body(source):
        first = ast.parse(source).body[0]
        if not (isinstance(first, ast.Expr)
                and isinstance(first.value, ast.Constant)):
            return source
        return "\n".join(source.split("\n")[first.end_lineno:])

    with open(os.path.join(repo, "rag_application_tpu", path)) as f:
        src = f.read()
    with open(os.path.join(repo, "rag_application_tpu_torch", path)) as f:
        copy = f.read()
    assert f"Copy of `rag_application_tpu/{path}`" in copy
    expect = body(src) if body(src) is not src else "\n" + src
    assert body(copy) == expect
    assert not re.search(r"^\s*(from|import) (jax|flax|rag_application_tpu)\b",
                         copy, re.M)
