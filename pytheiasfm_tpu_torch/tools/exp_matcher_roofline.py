"""Contraction-depth roofline sweep of the matcher's product (K2).

    python -m pytheiasfm_tpu_torch.tools.exp_matcher_roofline [--iters N]

Counterpart of the JAX package's `tools/exp_matcher_roofline.py`:
`matmul_rowmin` replaces its Pallas kernel (`make(TI, TJ, D, semantics).run`,
pallas_call at `:67`). The kernel is `csrc/matmul_rowmin.cu`, CUDA C++ for
Hopper (`sm_90a`) on the product core `csrc/mma_core.cuh`: a block keeps
128 rows of d1 in shared memory, d2t streams by TMA through a ring of
stages, `wgmma` forms the product and the row-min is taken from the
accumulator registers. Its rate is what the matcher's product can reach on
the card. `matmul_rowmin_reference` is its plain PyTorch version;
`matmul_rowmin` runs it for tensors on the CPU only, and on a CUDA tensor
launches the kernel or raises.

`main` sweeps D in {128, 256, 512} at P = 8 pairs of N = 4096 descriptors,
times the kernel by CUDA events after warm-up and prints TF/s and
microseconds per pair. The TPU tool's block-grid sweep (TI, TJ, dimension
semantics) has no counterpart: those are Mosaic grid parameters.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from ..utils.cuda_build import load_library
from ..utils.timing import cuda_time_ms

__all__ = ["matmul_rowmin", "matmul_rowmin_reference", "l2_bytes_per_launch", "sweep", "main"]

KERNEL = "matmul_rowmin"
BIG = 3.4e38  # the TPU kernel's initial row minimum (`exp_matcher_roofline.py:51`)
P, N = 8, 4096
DEPTHS = (128, 256, 512)


def matmul_rowmin_reference(d1, d2t):
    """Plain PyTorch version of K2: d1 [P, N, D] and d2t [P, D, N] (bf16
    on the card) -> [P, N] f32, min(BIG, min_j (d1 @ d2t)[p, i, j]). The
    bf16 inputs are upcast to f32 before the product, which then equals the
    kernel's bf16 x bf16 -> f32 accumulation up to summation order."""
    prod = d1.float() @ d2t.float()
    return torch.clamp(prod.amin(-1), max=BIG)


@functools.cache
def _kernel_lib():
    """The built kernel library with its C signatures declared."""
    lib = load_library(KERNEL)
    lib.matmul_rowmin_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    )
    lib.matmul_rowmin_launch.restype = ctypes.c_int
    for size in ("n_multiple", "k_chunk", "max_depth", "block_rows", "col_tile"):
        getattr(lib, f"matmul_rowmin_{size}").restype = ctypes.c_int
    return lib


def l2_bytes_per_launch(pairs: int, n: int, D: int) -> int:
    """Bytes one launch of the kernel reads through L2, from its tile sizes:
    every block of `block_rows` rows reads its d1 slab once and all of its
    pair's d2t, in steps of `col_tile` columns."""
    lib = _kernel_lib()
    rows, cols = lib.matmul_rowmin_block_rows(), lib.matmul_rowmin_col_tile()
    blocks = pairs * -(-n // rows)
    return blocks * 2 * (rows * D + D * cols * -(-n // cols))


def matmul_rowmin(d1, d2t):
    """Row minima of the bf16 product d1 @ d2t with f32 accumulation.

    d1 [P, N, D], d2t [P, D, N]; on CUDA both bf16, contiguous, N a
    multiple of the kernel's TMA box rows and D of its contraction chunk (64
    each), D at most what the kernel keeps resident in shared memory (640).
    Returns [P, N] f32.

    CPU tensors go to `matmul_rowmin_reference`; CUDA tensors launch the
    kernel (and count the launch in `matmul_rowmin.launches`). A barrier
    wait inside the kernel that does not end within 2 s traps: the launch
    then fails at the next synchronisation and the process's CUDA context
    is unusable from there on.
    """
    if not d1.is_cuda:
        return matmul_rowmin_reference(d1, d2t)
    Pp, Np, D = d1.shape
    for name, t, shape in (("d1", d1, (Pp, Np, D)), ("d2t", d2t, (Pp, D, Np))):
        if t.device != d1.device or t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(
                f"matmul_rowmin: {name} must be bfloat16 {shape} on {d1.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"matmul_rowmin: {name} must be contiguous and 16-byte aligned")
    lib = _kernel_lib()
    ti, kc = lib.matmul_rowmin_n_multiple(), lib.matmul_rowmin_k_chunk()
    if Pp == 0 or Np == 0 or Np % ti:
        raise ValueError(f"matmul_rowmin: N={Np} must be a positive multiple of {ti}")
    if D == 0 or D % kc or D > lib.matmul_rowmin_max_depth():
        raise ValueError(
            f"matmul_rowmin: D={D} must be a positive multiple of {kc}, at most "
            f"{lib.matmul_rowmin_max_depth()} (the d1 rows of a block stay in shared memory)"
        )
    out = torch.empty((Pp, Np), dtype=torch.float32, device=d1.device)
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
    err = lib.matmul_rowmin_launch(d1.data_ptr(), d2t.data_ptr(), Pp, Np, D, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"matmul_rowmin kernel launch failed: CUDA error {err}")
    matmul_rowmin.launches += 1
    return out


matmul_rowmin.launches = 0


def inputs(D: int, seed: int = 0, device="cuda", pairs: int = P, n: int = N):
    """The sweep's inputs at depth D: standard-normal d1 [pairs, n, D] and
    d2t [pairs, D, n] in bf16, made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(pairs, n, D)).astype(np.float32)
    d2t = rng.normal(size=(pairs, D, n)).astype(np.float32)
    return (
        torch.tensor(d1, device=device).bfloat16(),
        torch.tensor(d2t, device=device).bfloat16(),
    )


def sweep(iters: int = 30, warmup: int = 3):
    """Time K2 on the card at P = 8, N = 4096 for each depth. Returns a list
    of dicts (D, ms, tflops, us_per_pair), one per depth, each printed as
    it ends."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_matcher_roofline: needs a CUDA card")
    rows = []
    for D in DEPTHS:
        d1, d2t = inputs(D)
        ms = cuda_time_ms(lambda: matmul_rowmin(d1, d2t), iters, warmup)
        flops = 2.0 * P * N * N * D
        row = dict(D=D, ms=ms, tflops=flops / (ms * 1e-3) / 1e12, us_per_pair=1e3 * ms / P)
        print(f"D={D:4d}: {row['tflops']:6.1f} TF/s  {row['us_per_pair']:7.1f} us/pair",
              flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=30, help="timed launches per depth")
    args = parser.parse_args(argv)
    sweep(iters=args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
