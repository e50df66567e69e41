"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's); the
plain reference imports nothing of the port; nothing reads the TPU-era
bench files; without a card the command prints no result."""
import ast
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import SEED

BENCH = harness.BENCH_DIR
TPU_ERA = ("bench.py", "chip_smoke", "BENCH_r0", "MULTICHIP_r0", "BASELINE.json",
           "render_bench_table")


def _sources(top):
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _code_strings(path):
    """String constants that are not docstrings."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    for path in _sources(BENCH):
        names = set(_imports(path))
        assert not names & set(harness.FORBIDDEN), path
        if os.sep + "reference" + os.sep in path:
            assert "nvblox_mindmap_torch" not in names, path
        if os.sep + "tests" + os.sep not in path:
            assert not any(t in s for s in _code_strings(path) for t in TPU_ERA), path


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nvblox_mindmap_tpu_lookalike", sys)
    assert "nvblox_mindmap_tpu_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nvblox_mindmap_tpu.ops", sys)
    assert harness.forbidden_modules() == ["nvblox_mindmap_tpu.ops"]


def test_a_run_loads_no_jax():
    code = f"""
import sys, time
for name in {harness.FORBIDDEN!r}:
    sys.modules[name] = None  # importing it raises
import torch
from portbench import harness
from portbench.tests.conftest import tiny
res = harness.run_cell("radio_goal", {SEED}, 1.0, False, torch.device("cpu"), time.perf_counter(),
                       tiny("radio_goal"))
assert res["correct"], res["checks"]
for name in {harness.FORBIDDEN!r}:
    del sys.modules[name]
assert harness.forbidden_modules() == [], harness.forbidden_modules()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "radio_goal",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
