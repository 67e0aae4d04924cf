"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so`, then loaded with
`ctypes`. The build happens at first use, never at import; the hash covers
the source, the headers under `csrc/` (`*.cuh`, which any source may include)
and the flags, so an edited source or header is rebuilt. Several sources
build in parallel, one `nvcc` each (`build_libraries`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["build_libraries", "load_library", "build_log", "sass"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _tool(tool: str) -> str:
    """A program of the CUDA toolkit (`nvcc`, `cuobjdump`)."""
    found = shutil.which(tool)
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / tool
    if default.exists():
        return str(default)
    raise RuntimeError(
        f"{tool} not found (PATH, $CUDA_HOME/bin); the CUDA kernels of "
        "pytheiasfm_tpu_torch are compiled at first use on the GPU machine"
    )


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (`-Xptxas -v`: registers, shared memory,
    spills) of the current build of `name`, or "" if it is not built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The machine code of the current build of `name`, as `cuobjdump -sass`
    prints it. Raises if the library is not built or the tool fails."""
    done = subprocess.run(
        [_tool("cuobjdump"), "-sass", str(_target(name))],
        capture_output=True, text=True, check=True, timeout=120,
    )
    return done.stdout


def build_libraries(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, all at once."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_libraries([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
