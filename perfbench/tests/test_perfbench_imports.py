"""No module of the benchmark loads JAX or the JAX package; the reference
loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = _imports(path) & FORBIDDEN
        assert not bad, (path, bad)  # whole top-level names: repro_torch is not repro


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(path), path


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "from perfbench.tests.small import run\n"
            "from perfbench import harness\n"
            "r = run('rgg500k_p100.async', seconds=0.2)\n"
            "print(harness.foreign_modules(), r['correct'])\n")
    root = str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
