"""The port stands alone: every module of `pytheiasfm_tpu_torch` imports in a
process where `jax`, `pytheiasfm_tpu` and PIL cannot be imported (PIL is
optional: the image loader and the EXIF reader import it when they need
it), and `chip_smoke.py` imports neither (checked on its syntax tree)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_CHILD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["pytheiasfm_tpu"] = None
sys.modules["PIL"] = None
import pytheiasfm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "pytheiasfm_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(" ".join(names))
"""

# Modules added with the uncalibrated path and the RANSAC variants, with
# localization and the incremental and hybrid estimators, and with the rest
# of global pose.
_NEW_MODULES = ("math.sprt", "ops.p3p", "ops.pnp", "tools.localization", "ops.known_rotation",
                "sfm.localize", "sfm.incremental_estimator", "sfm.hybrid_estimator",
                "tools.incremental_sfm", "math.sdp", "math.qp",
                "global_pose.triplet_baseline")


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 85
    assert all(f"pytheiasfm_tpu_torch.{m}" in names for m in _NEW_MODULES)


def _imported_modules(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    names = _imported_modules(ROOT / "chip_smoke.py")
    assert "pytheiasfm_tpu_torch.matching" in names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "pytheiasfm_tpu"), name


def test_port_sources_import_neither():
    for path in (ROOT / "pytheiasfm_tpu_torch").rglob("*.py"):
        for name in _imported_modules(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "pytheiasfm_tpu"), (path, name)


def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path):
    """Without a CUDA card, and in a directory that holds nothing of the
    repository but the script, `chip_smoke.py` exits non-zero and prints no
    result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=300,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
