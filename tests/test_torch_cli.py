"""The port's three user commands (`pytheiasfm_tpu_torch/tools/
sfm_pipeline_images.py`, `sfm_eval_fountain.py`, `mvs_pipeline.py`) against
the repository's JAX commands (`tools/*.py`), on the CPU.

- The images command with `run_images_pipeline` replaced by a recorder in
  both packages (so the pipeline does not run twice here): the JAX
  command's arguments, defaults and JSON keys, and its PLY.
- The fountain command on `tests/test_torch_fountain.py`'s 8-view files,
  held to that module's bars (all cameras, the JAX package's edges and
  tracks, the median ATE bar); its JSON keys against the JAX command's on
  the same run's numbers.
- The MVS command against the JAX command run as a subprocess on the same
  `.recon` file (`JAX_PLATFORMS=cpu`, its XLA cache in the test's
  temporary directory): the same neighbour sets with scores within 1e-4,
  the camera files to 1e-9 relative, the same JSON; and from the npz
  checkpoint the same files.
- Each command without `--device` asks for the CUDA card and raises here.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytheiasfm_tpu_torch.io import recon as trecon
from pytheiasfm_tpu_torch.io import theia_recon as ttr
from pytheiasfm_tpu_torch.tools import mvs_pipeline as tmvs
from pytheiasfm_tpu_torch.tools import sfm_eval_fountain as tfountain_cli
from pytheiasfm_tpu_torch.tools import sfm_pipeline_images as timages_cli
from test_torch_fountain import MEDIAN_ATE_BAR_MM, SCENE, record, write_scene  # noqa: F401
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
NO_CARD = "runs on a CUDA card by default"


def _jax_command(name):
    """The repository's JAX command `tools/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_main(module, argv, monkeypatch, capsys):
    """`module.main()` on `argv`, its XLA cache kept out of the repository;
    returns its JSON line."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    capsys.readouterr()
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHEIASFM_TPU_CACHE", str(tmp_path / "jax_cache"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("cli")))


def _recorder(calls, models):
    stats = {"t_extract_s": 0.1, "features_per_image": [2048, 2047], "t_match_verify_s": 0.2,
             "verified_pairs": 1, "t_reconstruct_s": 0.3, "models": len(models),
             "views_estimated": 2, "tracks_estimated": 40}

    def run(paths, **kwargs):
        calls.append((list(paths), kwargs))
        return models, dict(stats)

    return run


def test_images_command_matches_the_jax_command(tmp_path, files, jax_cache, monkeypatch,
                                                capsys):
    """The same pipeline arguments and defaults (`--ratio 0.85`,
    `--min-inliers 15`, which differ from `run_images_pipeline`'s), the
    same JSON, and the first model's PLY with its tracks and cameras."""
    from pytheiasfm_tpu.io import theia_recon as jtr
    from pytheiasfm_tpu.pipelines import images as jimages

    gt = ttr.read_theia_reconstruction(files[1])
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jimages, "run_images_pipeline",
                        _recorder(jax_calls, [jtr.read_theia_reconstruction(files[1])]))
    monkeypatch.setattr(timages_cli, "run_images_pipeline", _recorder(port_calls, [gt]))
    jcli = _jax_command("sfm_pipeline_images")
    for extra in ([], ["--estimator", "hybrid", "--max-dim", "640", "--ratio", "0.8",
                       "--min-inliers", "30", "--max-features", "1000"]):
        argv = ["a.png", "b.png"] + extra
        want = _run_jax_main(jcli, argv + ["--ply", str(tmp_path / "j.ply")], monkeypatch,
                             capsys)
        got = timages_cli.main(argv + ["--ply", str(tmp_path / "t.ply")])
        printed = json.loads(capsys.readouterr().out.strip())
        assert printed == got
        assert {k: v for k, v in got.items() if k != "ply"} == {
            k: v for k, v in want.items() if k != "ply"}
        assert set(got) == set(want) and got["ply"] == str(tmp_path / "t.ply")
        (jpaths, jkw), (tpaths, tkw) = jax_calls[-1], port_calls[-1]
        assert tpaths == jpaths == ["a.png", "b.png"]
        assert tkw.pop("device") is None
        assert tkw == jkw
    assert port_calls[0][1]["lowes_ratio"] == 0.85
    assert port_calls[0][1]["min_num_inlier_matches"] == 15
    ply = (tmp_path / "t.ply").read_text()
    assert ply == (tmp_path / "j.ply").read_text()
    vertices = int(ply.split("element vertex ")[1].split()[0])
    assert vertices == int(gt.track_estimated.sum()) + int(gt.view_estimated.sum())

    timages_cli.main(["a.png", "--device", "cpu"])
    assert port_calls[-1][1]["device"] == "cpu"


def test_fountain_command_meets_the_fountain_bars(files, record, jax_cache, monkeypatch,  # noqa: F811
                                                  capsys):
    """The fountain command on the 8-view files on the CPU, twice
    (`--repeat 2`): `tests/test_torch_fountain.py`'s bars; the JAX command's
    JSON keys and values on the same run's numbers."""
    from pytheiasfm_tpu.pipelines import fountain as jfountain

    want = dict(zip(("median_mm", "mean_mm", "max_mm", "cameras", "edges", "tracks_used"),
                    record["evaluate"]))
    runs = []
    real = tfountain_cli.fountain.evaluate

    def evaluate(**kwargs):
        runs.append(real(**kwargs))
        return runs[-1]

    monkeypatch.setattr(tfountain_cli.fountain, "evaluate", evaluate)
    got = tfountain_cli.main(["--tracks", files[0], "--gt", files[1], "--device", "cpu",
                              "--repeat", "2"])
    assert json.loads(capsys.readouterr().out.strip()) == got
    assert len(runs) == 2 and got["success"]
    assert got["cameras"] == f"{SCENE.num_views}/{SCENE.num_views}"
    assert got["edges"] == want["edges"] and got["tracks_used"] == want["tracks_used"]
    assert got["value"] < MEDIAN_ATE_BAR_MM
    assert got["t_total_first_run_s"] == round(runs[0]["t_total_s"], 2)

    monkeypatch.setattr(jfountain, "evaluate", lambda **kwargs: runs[-1])
    jwant = _run_jax_main(_jax_command("sfm_eval_fountain"), ["--repeat", "2"], monkeypatch,
                          capsys)
    assert set(got) == set(jwant)
    jwant["cameras"] = got["cameras"]  # the JAX command's denominator is fountain-11's 11
    assert {k: v for k, v in got.items() if not k.startswith("t_")} == {
        k: v for k, v in jwant.items() if not k.startswith("t_")}


def _camera_files(directory):
    return sorted(p for p in os.listdir(directory) if p.startswith("cam_"))


def _pairs(path):
    lines = Path(path).read_text().split("\n")
    out = {}
    for k in range(int(lines[0])):
        view, row = int(lines[1 + 2 * k]), lines[2 + 2 * k].split()
        assert int(row[0]) == (len(row) - 1) // 2
        out[view] = {int(n): float(s) for n, s in zip(row[1::2], row[2::2])}
    return out


def _numbers(path):
    return np.array([float(x) for x in Path(path).read_text().split()
                     if x not in ("extrinsic", "intrinsic")])


def test_mvs_command_matches_the_jax_command(tmp_path, files):
    """The JAX command in a subprocess on the 8-view scene's ground truth
    against the port's on the CPU: the same views, neighbour sets, scores
    within 1e-4 and camera files to 1e-9 relative; the npz checkpoint of the
    same reconstruction gives the port the same files."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHEIASFM_TPU_CACHE=str(tmp_path / "cache"))
    jout, tout, nout = tmp_path / "jax", tmp_path / "port", tmp_path / "npz"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "mvs_pipeline.py"), files[1], "--out", str(jout),
         "--neighbors", "4", "--cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300, check=True)
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = tmvs.main([files[1], "--out", str(tout), "--neighbors", "4", "--device", "cpu"])
    assert {k: v for k, v in got.items() if k != "out"} == {
        k: v for k, v in want.items() if k != "out"}
    assert got["views"] == SCENE.num_views and got["value"] == SCENE.num_views

    jpairs, tpairs = _pairs(jout / "pair.txt"), _pairs(tout / "pair.txt")
    assert list(tpairs) == list(jpairs)
    for v in jpairs:
        assert set(tpairs[v]) == set(jpairs[v]) and len(jpairs[v]) == 4
        for n, score in jpairs[v].items():
            assert abs(tpairs[v][n] - score) <= 1e-4, (v, n)
    names = _camera_files(jout)
    assert _camera_files(tout) == names and len(names) == SCENE.num_views
    for name in names:
        a, b = _numbers(jout / name), _numbers(tout / name)
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)

    npz = str(tmp_path / "gt.npz")
    trecon.write_reconstruction(ttr.read_theia_reconstruction(files[1]), npz)
    tmvs.main([npz, "--out", str(nout), "--neighbors", "4", "--device", "cpu"])
    for name in ["pair.txt"] + names:
        assert (nout / name).read_text() == (tout / name).read_text(), name


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="a CUDA card is present")
def test_commands_ask_for_the_card(files):
    """Without `--device` each command runs on the CUDA card, and raises
    where there is none."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        timages_cli.main([files[0]])
    with pytest.raises(RuntimeError, match=NO_CARD):
        tfountain_cli.main(["--tracks", files[0], "--gt", files[1]])
    with pytest.raises(RuntimeError, match=NO_CARD):
        tmvs.main([files[1]])


COMMANDS = ("sfm_pipeline_images", "sfm_eval_fountain", "mvs_pipeline")
_HELP = """
import contextlib, io, runpy, sys
for name in sys.argv[1:]:
    sys.argv = [name, "--help"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.suppress(SystemExit):
        runpy.run_module(f"pytheiasfm_tpu_torch.tools.{name}", run_name="__main__")
    print(f"=== {name}\\n" + buf.getvalue())
"""


def test_commands_run_as_modules():
    """Each command run as `python -m pytheiasfm_tpu_torch.tools.<name>
    --help` (in one interpreter) offers the JAX command's options, `--cpu`
    as `--device`."""
    proc = subprocess.run([sys.executable, "-c", _HELP, *COMMANDS], capture_output=True,
                          text=True, cwd=str(REPO), timeout=120, check=True)
    helps = dict(part.split("\n", 1) for part in proc.stdout.split("=== ")[1:])
    assert sorted(helps) == sorted(COMMANDS)
    for name, text in helps.items():
        jax_source = (REPO / "tools" / f"{name}.py").read_text()
        options = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', jax_source)) - {"--cpu"}
        assert options and all(o in text for o in options), (name, options, text)
        assert "--device" in text and "--cpu" not in text
