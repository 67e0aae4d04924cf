"""What the benchmark imports: nothing of JAX or the JAX package anywhere
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the program in the plain reference."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pytheiasfm_tpu"}


def _imports(path: Path):
    """Top-level names of the modules a file imports (relative imports as
    None)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield None if node.level else node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_is_imported(path):
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "pytheiasfm_tpu_torch" not in names
    # Relative imports stay inside the reference package.
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, "a relative import leaves reference/"


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time\n"
        "from sfmbench.tests import tiny\n"
        "from sfmbench import harness\n"
        "from pathlib import Path\n"
        f"root = tiny.checkout(Path({str(tmp_path)!r}))\n"
        "rc = harness.main(['--workload', 'ba.bal_tiny', '--seed', '3', '--seconds', '0.2'],\n"
        "                  time.perf_counter(), root=root, require_cuda=False)\n"
        "assert rc == 0, rc\n"
        "print('LOADED', harness.forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"
