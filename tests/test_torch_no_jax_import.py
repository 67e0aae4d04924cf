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
# localization and the incremental and hybrid estimators, with the rest of
# global pose, with the remaining minimal solvers, with the I/O, the
# fountain pipeline and the Sim(3) and MVS auxiliaries, with the device
# mesh, and with the three user commands.
_NEW_MODULES = ("math.sprt", "ops.p3p", "ops.pnp", "tools.localization", "ops.known_rotation",
                "sfm.localize", "sfm.incremental_estimator", "sfm.hybrid_estimator",
                "tools.incremental_sfm", "math.sdp", "math.qp",
                "global_pose.triplet_baseline", "ops.focal_radial", "ops.radial_homography",
                "ops.generalized_pose", "ops.orthographic", "ops.partial_rotation", "ops.lie",
                "tools.minimal_solvers", "io", "io.recon", "io.theia_recon", "io.ply",
                "io.colmap", "io.bundler", "io.nvm", "io.nerfstudio", "io.calibration",
                "io.strecha", "io.onedsfm", "pipelines.fountain", "transforms.pose_graph_sim3",
                "mvs", "mvs.view_selection", "sfm.colorize_reconstruction",
                "matching.fisher_vector", "tools.file_scene", "parallel", "parallel.sharding",
                "parallel.distributed", "parallel.multihost", "tools.mesh_sfm",
                "tools.sfm_pipeline_images", "tools.sfm_eval_fountain", "tools.mvs_pipeline")


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


def test_no_mesh_path_raises_not_implemented():
    """Every path that takes the JAX package's `mesh` is ported: no
    `NotImplementedError` in the port names a mesh (the abstract interface of
    `matching/database.py` raises it for other reasons)."""
    for path in (ROOT / "pytheiasfm_tpu_torch").rglob("*.py"):
        if path.relative_to(ROOT).as_posix() == "pytheiasfm_tpu_torch/matching/database.py":
            continue
        source = path.read_text()
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Raise) and node.exc is not None:
                text = ast.get_source_segment(source, node) or ""
                if "NotImplementedError" in text:
                    assert "mesh" not in text.lower() and "G1" not in text, (path, text)
