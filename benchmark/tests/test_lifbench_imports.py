"""Nothing the benchmark runs imports JAX or the JAX package, and its
references import nothing of the program: by whole top-level module
name, so lif_tpu_torch is not lif_tpu."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "lif_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if ".cache" not in p.parts and "tests" not in p.parts)


def imported(path):
    """Top-level names of every module the file imports, at any depth;
    a relative import counts as the benchmark's own."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "lif_tpu_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "math", "numpy", "torch", "benchmark"}


def test_imports_count_whole_names():
    """lif_tpu_torch begins with lif_tpu and is allowed."""
    assert "lif_tpu_torch".split(".")[0] not in FORBIDDEN


RUN_TINY = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark.lifbench import harness
res, _ = harness.run({root!r}, "sfmoma.view", 2**31 + 11, 0.3, False,
                     time.perf_counter(), device="cpu", overrides={{
                         "config": {{"width": 48, "height": 32}},
                         "check": {{"sample_frames": 2,
                                    "strata": {{"x": [0.0, 0.135, 2]}}}}}})
assert res["correct"], res
print(sorted({{k.split(".")[0] for k in sys.modules}}
             & {forbidden!r}))
"""


def test_no_jax_loaded_after_a_cpu_run():
    """A run of a tiny cell on the CPU, in a fresh process, loads no
    module of JAX or the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", RUN_TINY.format(root=str(ROOT),
                                               forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
