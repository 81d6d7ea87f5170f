"""The port stands alone: every module of `rag_application_tpu_torch`, and
`chip_smoke.py`, imports with JAX blocked, and none of them loads the JAX
package."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None  # any import of these now raises
import rag_application_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
        if not m.name.rsplit(".", 1)[-1].startswith("lib")]  # built .so files
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m == "rag_application_tpu" or m.startswith("rag_application_tpu."))
assert not leaked, leaked
print(" ".join(mods))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.strip().splitlines()[-1].split())
    # ops (incl. decode_attn, graph_hop), index (incl. payload,
    # checkpoint), search (incl. params, rerank, batcher, hybrid,
    # orchestration), kg, kernels, native (incl. wordpiece_lib), models
    # (decoder, wordpiece, encoder, embedder, tokenizer, cache), store
    # (collection, objects), llm (router, local, bedrock, provision,
    # vlm), ingest (pipeline and its parsers), tools (registry, web,
    # knowledge, browser, mcp_client), agents, index.ivf, api (http,
    # users, chat_ui, app), mcp (server, file_server, search_server),
    # serve, models.constrain, llm.scheduler, models.speculative,
    # models.bert, the media front ends (models.image, models.jpeg,
    # models.audio, ingest.flac), training and LoRA (models.train_data,
    # models.train, models.lora), the evals (evals.real_docs,
    # evals.multimodal) and corpus-axis sharding (parallel.mesh,
    # parallel.sparse, parallel.search, parallel.kg, parallel.ivf), utils,
    # config, state, ...
    assert len(mods) >= 105
    assert {f"rag_application_tpu_torch.{m}" for m in (
        "index.checkpoint", "search.batcher", "search.hybrid",
        "search.orchestration", "ops.graph_hop", "kg.store",
        "kg.checkpoint", "kg.dedup", "kg.extract", "ingest.pipeline",
        "ingest.queue", "ingest.pdf", "ingest.jbig2", "store.objects",
        "tools.web", "index.ivf", "tools.knowledge", "tools.browser",
        "agents", "agents.memory", "agents.base_agent", "agents.chat_agent",
        "agents.waiter_agent", "agents.deep_research", "llm.vlm",
        "llm.bedrock", "llm.provision", "api", "api.http", "api.users",
        "api.chat_ui", "api.app", "mcp", "mcp.server", "mcp.file_server",
        "mcp.search_server", "serve", "models.constrain",
        "tools.mcp_client", "llm.scheduler", "models.speculative",
        "models.bert", "models.image", "models.jpeg", "models.audio",
        "ingest.flac", "models.train_data", "models.train",
        "models.lora", "evals", "evals.real_docs", "evals.multimodal",
        "parallel", "parallel.mesh", "parallel.sparse", "parallel.search",
        "parallel.kg", "parallel.ivf")} <= mods
