"""Native (C++) host-runtime kernels, compiled at first use, bound by ctypes.

The port's own copy of the JAX package's `native/` (`graphcore.cpp`:
union-find components, as the reference builds tracks; greedy MFAS
ordering, `filter_view_pairs_from_relative_translation.cc:165`). Both are
bound: the MFAS ordering (1DSfM's) and the components (the track
builder's). The library is built with the system `g++` into
`pytheiasfm_tpu_torch/_build/`, named by a hash of the source and the
flags, so an edited source is rebuilt; never at import. A failed build raises: there is no quiet
fallback. The numpy `math.graph.mfas_ordering_reference` and
`sfm.view_graph.UnionFind` are the plain versions the tests hold them
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["build", "mfas_ordering", "uf_components"]

_SRC = Path(__file__).resolve().parent / "graphcore.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgraphcore-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `graphcore.cpp` unless its current build exists; returns the
    library's path. Raises RuntimeError with the compiler's output if the
    build fails."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(
            ["g++", *CXX_FLAGS, str(_SRC), "-o", tmp],
            capture_output=True, text=True, timeout=300,
        )
        if done.returncode != 0:
            raise RuntimeError(
                f"graphcore build failed: g++ exited {done.returncode}\n"
                f"{done.stdout}{done.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.mfas_ordering.argtypes = [
                ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p, i64p,
            ]
            lib.mfas_ordering.restype = None
            lib.uf_components.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p]
            lib.uf_components.restype = None
            _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _node_ids(a, num_nodes: int) -> np.ndarray:
    """Contiguous int64 node ids, checked to lie in [0, num_nodes)."""
    a = np.ascontiguousarray(a, np.int64)
    if a.size and (a.min() < 0 or a.max() >= num_nodes):
        raise ValueError(f"node ids must lie in [0, {num_nodes})")
    return a


def mfas_ordering(num_nodes: int, src, dst, weights) -> np.ndarray:
    """Greedy MFAS ordering: the position of each node."""
    s = _node_ids(src, num_nodes)
    d = _node_ids(dst, num_nodes)
    w = np.ascontiguousarray(weights, np.float64)
    if not len(s) == len(d) == len(w):
        raise ValueError("src, dst and weights differ in length")
    out = np.empty(num_nodes, np.int64)
    _load().mfas_ordering(
        num_nodes, len(s), _ptr(s, ctypes.c_int64), _ptr(d, ctypes.c_int64),
        _ptr(w, ctypes.c_double), _ptr(out, ctypes.c_int64),
    )
    return out


def uf_components(num_nodes: int, edges_a, edges_b) -> np.ndarray:
    """Connected components over an edge list: the root of each node's
    component (union by size, path compression; `theia::ConnectedComponents`)."""
    a = _node_ids(edges_a, num_nodes)
    b = _node_ids(edges_b, num_nodes)
    if len(a) != len(b):
        raise ValueError("edges_a and edges_b differ in length")
    out = np.empty(num_nodes, np.int64)
    _load().uf_components(
        num_nodes, len(a), _ptr(a, ctypes.c_int64), _ptr(b, ctypes.c_int64),
        _ptr(out, ctypes.c_int64),
    )
    return out
