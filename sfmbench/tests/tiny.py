"""Tiny cells of the benchmark for the CPU tests: a copy of the benchmark's
files in a temporary checkout, with a BENCHMARK.json whose cell runs the
real driver, readers and reference at a size the CPU holds."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from sfmbench import harness

REPO = Path(__file__).resolve().parents[2]

BAL = {"views": 16, "tracks": 600, "observations": 3000, "min_length": 2, "max_length": 8,
       "neighborhood": 5, "noise_px": 0.5, "focal_range": [800.0, 1600.0],
       "k1_range": [-0.1, 0.1], "k2_range": [-0.02, 0.02], "start_position_sigma": 0.02,
       "start_rotation_sigma_deg": 0.2, "start_focal_sigma": 0.02, "start_k1_sigma": 0.01,
       "start_k2_sigma": 0.002, "start_point_sigma": 0.01, "problem_seed": 4}


def checkout(tmp: Path) -> Path:
    """A checkout at `tmp` holding the benchmark's files, with the tiny
    configuration `bal_tiny` and the cell `ba.bal_tiny` in place of the
    real ones."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "sfmbench", root / "sfmbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "sfmbench" / "configs" / "bal_dubrovnik.json").read_text())
    cfg.update(name="bal_tiny", sizes=BAL, threads=2)
    (root / "sfmbench" / "configs" / "bal_tiny.json").write_text(json.dumps(cfg))
    text = json.dumps(bench).replace("ba.bal_dubrovnik", "ba.bal_tiny")
    (root / "BENCHMARK.json").write_text(text.replace('"bal_dubrovnik"', '"bal_tiny"'))
    return root


def run(root: Path, workload: str, seed=7, seconds=0.5, trace=0, capsys=None, variant=None):
    """One run of `workload` on the CPU in this process: (exit code, the
    parsed last line or None)."""
    t0 = time.perf_counter()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + ([] if variant is None else ["--variant", variant])
    code = harness.main(argv, t0, root=root, require_cuda=False)
    if capsys is None:
        return code, None
    out = capsys.readouterr().out.strip().splitlines()
    return code, (json.loads(out[-1]) if code == 0 and out else None)

