"""The port stands alone: every module of `rag_application_tpu_torch`, and
`chip_smoke.py`, imports with JAX blocked, and none of them loads the JAX
package."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None  # any import of these now raises
import rag_application_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
        if not m.name.rsplit(".", 1)[-1].startswith("lib")]  # built .so files
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m == "rag_application_tpu" or m.startswith("rag_application_tpu."))
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # ops (incl. decode_attn), index (incl. payload), search (incl.
    # params, rerank), kernels, native (incl. wordpiece_lib), models
    # (decoder, wordpiece, encoder, embedder, tokenizer, cache), store
    # (collection), llm (router, local), utils, config, state, ...
    assert int(out.stdout.strip().splitlines()[-1]) >= 38
