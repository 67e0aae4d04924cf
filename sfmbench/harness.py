"""The benchmark's runner: one cell of `BENCHMARK.json`, one process.

    python3 -m sfmbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything particular lives in files found by name: the cell's configuration
`configs/<config>.json` (sizes, the host threads, the precision, the limits
of the check), its traffic `traffic/<traffic>.json` (parameters, and the
driver `drivers/<driver>.py` that runs one step), the scene generator
`scenes/<scene>.py` the configuration names, and one reader for each
metric: `metrics/<metric>.py`, or where there is none, the reader of the
name before its first dot (`launches.ba` reads with `metrics/launches.py`).
A cell, a traffic mix or a metric is added by adding such files and
entries; this file does not change.

A run: set-up (threads, inputs from the seed, one warm step at the cell's
shapes, `gc.freeze()`), counted in `setup_s`; then whole steps back to back
until `--seconds` have passed (the window); then the check against the
plain reference, and one JSON line. With `--trace 1` the window runs under
`torch.profiler` and the line carries the per-layer metrics.

`--variant <name>` (never given by the benchmark's own runs) swaps the
driver's timed path for one of the driver's `VARIANTS`: its control in a
lower precision, or a planted fault. The rest of the run, the check
included, is as always, so such a run has to print `correct` false.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import math
import json
import os
import sys
import time
from pathlib import Path

from . import tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pytheiasfm_tpu")


class Setup(Exception):
    """A run that cannot start: the message goes to standard error and the
    process exits with code 2, printing no result."""


def load_module(path: Path, name: str):
    """Import the file at `path` as module `name` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise Setup(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, workload: str):
    """(benchmark, cell, configuration, traffic) of `workload`, from the
    checkout at `root`."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Setup(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    base = root / HERE.name
    config = json.loads((base / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def find_reader(base: Path, name: str) -> Path:
    """The reader file of metric `name`: its own, else that of the name
    before its first dot."""
    own = base / "metrics" / f"{name}.py"
    return own if own.is_file() else base / "metrics" / f"{name.split('.')[0]}.py"


def cell_metrics(bench, cell, traced: bool):
    """The metrics the cell reports: its end-to-end metrics, or with a
    trace its per-layer ones; a metric with `workloads` only in those."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def pin_host(threads: int, root: Path) -> None:
    """The host's thread counts and the program's cache directories, set
    before numpy or torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(threads)
    cache = root / ".sfmbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


class Run:
    """What the metric readers read: `setup_s`, `window_s`, `steps` (whole
    steps in the window), `counters` (the driver's sums over the window's
    steps, e.g. LM iterations) and `trace` (a `tracing.Trace`, or None
    without one)."""

    def __init__(self, setup_s, window_s, steps, counters, trace):
        self.setup_s = setup_s
        self.window_s = window_s
        self.steps = steps
        self.counters = counters
        self.trace = trace

    def per_step(self, total):
        return None if total is None or not self.steps else total / self.steps


def _finite(v):
    """A number JSON can hold: a value that is not finite reads 1e300."""
    return float(v) if math.isfinite(v) else 1e300


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m sfmbench", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", default=None,
                   help="a control or planted fault of the driver (checks only)")
    return p.parse_args(argv)


def main(argv, t0: float, root: Path | None = None, require_cuda: bool = True) -> int:
    """Run one cell; `t0` is the host clock at process start. Returns the
    exit code. `require_cuda=False` (tests only) runs on the CPU."""
    args = parse(argv)
    root = Path.cwd() if root is None else root
    if args.seed < 0:
        print("sfmbench: --seed takes a whole number", file=sys.stderr)
        return 2
    try:
        bench, cell, config, traffic = load_cell(root, args.workload)
    except (Setup, OSError, KeyError, ValueError) as e:
        print(f"sfmbench: {e}", file=sys.stderr)
        return 2
    pin_host(int(config["threads"]), root)

    import gc

    import torch

    torch.set_num_threads(int(config["threads"]))
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"sfmbench: {cell['chips']} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    base = root / HERE.name
    metrics = cell_metrics(bench, cell, bool(args.trace))
    readers = {m["name"]: load_module(find_reader(base, m["name"]),
                                      f"sfmbench_metric_{m['name']}") for m in metrics}
    scene = load_module(base / "scenes" / f"{config['scene']}.py",
                        f"sfmbench_scene_{config['scene']}")
    drivers = importlib.import_module(f"sfmbench.drivers.{traffic['driver']}")
    if args.variant is not None and args.variant not in drivers.VARIANTS:
        print(f"sfmbench: no variant {args.variant!r}; the driver has "
              + ", ".join(drivers.VARIANTS), file=sys.stderr)
        return 2

    # Where a run's time goes: seconds from process start to each mark.
    marks = {"imported": time.perf_counter() - t0}
    inputs = scene.build(**config["sizes"], seed=args.seed)
    marks["inputs"] = time.perf_counter() - t0
    driver = drivers.Driver(config, traffic, inputs, args.seed, device, variant=args.variant)
    del inputs
    marks["driver"] = time.perf_counter() - t0
    warm_s = driver.warm()
    marks["warm"] = time.perf_counter() - t0
    driver.prepare(args.seconds, warm_s)
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    prof = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    steps = 0
    with tracing.labelled(tracing.WINDOW):
        start = time.perf_counter()
        while steps == 0 or time.perf_counter() - start < args.seconds:
            with tracing.labelled(tracing.STEP):
                driver.step(steps)
            steps += 1
        window_s = time.perf_counter() - start
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = tracing.reduce(prof)
        del prof
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    attempted, failed = driver.outcome(steps)
    run = Run(setup_s, window_s, steps, driver.counters(steps), trace)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(steps)
    marks["checked"] = time.perf_counter() - t0
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks)

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print("sfmbench: modules of JAX or the JAX package loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    result["notes"] = notes = {**driver.notes(), "marks_s": marks}
    print("sfmbench: " + json.dumps(notes), file=sys.stderr)
    result["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
