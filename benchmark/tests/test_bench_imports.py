"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
BENCH = os.path.join(ROOT, "benchmark")
PORT = "rag_application_tpu_torch"


def _imports(path):
    """Top-level names a file imports (relative imports as '.')."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def test_no_benchmark_file_names_jax_or_the_jax_package():
    files = [f for f in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                  recursive=True)]
    assert files
    for f in files:
        assert not _imports(f) & set(harness.FORBIDDEN), f


def test_the_reference_imports_nothing_of_the_port():
    # the reference and the benchmark modules it reaches
    files = glob.glob(os.path.join(BENCH, "reference", "*.py")) + [
        os.path.join(BENCH, "data.py")]
    for f in files:
        assert PORT not in _imports(f), f
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.search, benchmark.reference.decoder\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % ROOT)
    tops = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=300).stdout)
    assert PORT not in tops and not set(tops) & set(harness.FORBIDDEN)


def test_a_run_of_every_driver_loads_no_jax():
    """Both drivers, end to end on the CPU at tiny sizes, in a process of
    their own: what they and the port load holds no forbidden name."""
    code = """
import sys, time, json
sys.path.insert(0, %r)
sys.path.insert(0, %r)
import torch
from benchmark import harness
import conftest
for cell in (conftest.tiny_search("hybrid-1m768.mixed-8192"),
             conftest.tiny_generate()):
    out, _ = harness.driver_for(cell).run(
        cell, conftest.SEED, 0.5, True, torch.device("cpu"),
        time.perf_counter())
    assert out.correct, out.checks
print(json.dumps(harness.forbidden_modules()))
""" % (ROOT, os.path.join(BENCH, "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in (PORT, PORT + ".search", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rag_application_tpu.ops", sys)
    assert harness.forbidden_modules() == ["rag_application_tpu"]


def test_a_bare_copy_of_the_benchmark_fails_without_a_result(tmp_path):
    """Only BENCHMARK.json and the files under its paths: no program to
    run, so no result and a code other than 0."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hybrid-1m768.vectors-8192", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_no_card_no_result():
    """Here, without CUDA, a run exits other than 0 and prints nothing."""
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hybrid-1m768.vectors-8192", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
