"""The benchmark's runner on the CPU at a tiny size: the cell end to end, a
cell, a traffic mix and a metric added from files alone, the refusals (no
card, a directory without the program, JAX loaded) and the reduction of a
trace worked by hand. The control and the planted faults are in
`test_sfmbench_control.py`."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from sfmbench import harness
from sfmbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("sfmbench"))


def _result(capsys, root, workload, **kw):
    code, line = tiny.run(root, workload, capsys=capsys, **kw)
    assert code == 0
    return line


def test_a_tiny_cell_runs_end_to_end(capsys, root):
    line = _result(capsys, root, "ba.bal_tiny")
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"ba_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert line["device"]["count"] == 1


def test_a_traced_run_reports_the_layers(capsys, root):
    # The CPU has no device trace: the device's metrics are left out, the
    # program's counters are read.
    line = _result(capsys, root, "ba.bal_tiny", trace=1)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"lm_iterations.ba", "pcg_steps.ba"}


def test_a_cell_traffic_and_metric_added_from_files_alone(capsys, root, tmp_path):
    new = tiny.checkout(tmp_path)
    cfg = json.loads((new / "sfmbench/configs/bal_tiny.json").read_text())
    cfg.update(name="bal_other", sizes={**cfg["sizes"], "views": 20, "tracks": 500,
                                         "observations": 2600})
    (new / "sfmbench/configs/bal_other.json").write_text(json.dumps(cfg))
    traffic = json.loads((new / "sfmbench/traffic/ba.json").read_text())
    (new / "sfmbench/traffic/ba_one_check.json").write_text(
        json.dumps({**traffic, "checked_solves": 1}))
    (new / "sfmbench/metrics/solves.py").write_text(
        "def read(run):\n    return run.steps\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bal_other", "source": "test", "reduced": [],
                             "file": "sfmbench/configs/bal_other.json", "why": "test"})
    bench["workloads"].append({"name": "ba.bal_other", "config": "bal_other",
                               "traffic": "ba_one_check", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "solves.ba", "unit": "solves", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "ba_s", "workloads": ["ba.bal_other"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    line = _result(capsys, new, "ba.bal_other", trace=1)
    assert line["correct"] is True
    assert line["metrics"]["solves.ba"]["value"] == line["attempted"]
    assert "solves.ba" not in _result(capsys, new, "ba.bal_tiny", trace=1)["metrics"]


def test_no_card_means_no_result(capsys, root):
    t0 = 0.0
    code = harness.main(["--workload", "ba.bal_tiny", "--seed", "1", "--seconds", "1"], t0,
                        root=root)
    captured = capsys.readouterr()
    assert code != 0 and captured.out == ""
    assert "CUDA" in captured.err


def test_a_directory_without_the_program_exits_without_a_result(root, tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((root / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(tiny.REPO / "sfmbench"), str(bare / "sfmbench")],
                   check=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "sfmbench", "--workload", "ba.bal_tiny",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=bare,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "correct" not in proc.stdout


def test_jax_loaded_in_the_process_means_no_result(capsys, root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    code, line = tiny.run(root, "ba.bal_tiny", capsys=capsys)
    assert code != 0 and line is None


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _self: events})()


def test_trace_reduction_worked_by_hand():
    from sfmbench import tracing
    ev = [_Event(tracing.WINDOW, 1000, 9000, False),
          _Event("stage:bundle adjustment", 1000, 4000, False),
          _Event("harness:copy", 6000, 1000, False),
          _Event("k1", 500, 1000, True),      # starts before the window: not counted
          _Event("stage:bundle adjustment", 1500, 3000, True),  # a range's mirror: not an op
          _Event(tracing.STEP, 1000, 9000, True),
          _Event("k1", 1500, 1000, True),     # busy 1500-2500
          _Event("k2", 2000, 1000, True),     # overlaps: busy to 3000
          _Event("Memcpy HtoD", 6500, 500, True),  # a copy, not a launch
          _Event("k2", 8000, 1000, True)]     # busy 8000-9000; idle 9000-10000
    t = tracing.reduce(_Prof(ev))
    assert t.window_s == pytest.approx(9e-6)
    assert t.busy_s == pytest.approx(3e-6)  # 1500-3000, 6500-7000, 8000-9000
    assert t.launches == 3 and t.device_s == pytest.approx(3.5e-6)
    assert t.device_ops[0] == ["k2", pytest.approx(2e-6)]
    gaps = dict((round(s * 1e9), lbl) for lbl, s in t.idle_gaps)
    assert gaps == {3500: "stage:bundle adjustment", 1000: "outside_stages",
                    500: "stage:bundle adjustment"}
