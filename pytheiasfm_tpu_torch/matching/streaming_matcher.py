"""Streaming descriptor matcher (K1): fused distances + both-direction top-2.

Counterpart of the JAX package's `matching/pallas_matcher.py`:
`streaming_top2` replaces the Pallas kernel of the same name (pallas_call at
`pallas_matcher.py:195`), `match_descriptors_batch_streaming` the wrapper
`match_descriptors_batch_pallas` (`:236-289`). The kernel is
`csrc/streaming_top2.cu`, CUDA C++ for Hopper (`sm_90a`) on the product
core `csrc/mma_core.cuh`, whose header states its bound and design: TMA
loads, `wgmma`, and both directions as row top-2s taken from the
accumulator registers (the reverse one on the transposed product).
`streaming_top2_reference` is its plain PyTorch version; `streaming_top2`
runs it for tensors on the CPU only, and on a CUDA tensor launches the
kernel or raises.

The wrapper keeps the JAX wrapper's conventions: norms from the f32
descriptors, descriptors to the kernel in bf16, +BIG in the norms of masked
rows, `< BIG/2` validity tests, and Lowe's ratio and the symmetric
cross-check as plain tensor code outside the kernel. d2 stays [P, N, D]:
the TPU kernel's transposed copy existed only because Mosaic rejects
rhs-contracted bf16 matmuls.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library

__all__ = [
    "l2_bytes_per_launch",
    "match_descriptors_batch_streaming",
    "padded_norms",
    "streaming_inputs",
    "streaming_top2",
    "streaming_top2_reference",
]

BIG = 3.4e38  # the TPU kernel's finite "infinity" (`pallas_matcher.py:50`)
KERNEL = "streaming_top2"
K_CHUNK = 64  # the kernel's contraction chunk (KC in the .cu): D pads to it
BLOCK_ROWS = 128  # rows per block (R in the .cu)
COL_TILE = 128  # columns per tile (TJ in the .cu)


def _init_merge(m1, m2, arg, big):
    """Merge a global (best, second, argmin) into the TPU kernel's initial
    accumulator (BIG, BIG, index 0), as its strict-`<` merge does."""
    win = m1 < big
    return (
        torch.clamp(m1, max=big),
        torch.clamp(m2, max=big),
        torch.where(win, arg, torch.zeros_like(arg)),
    )


def _top2_lowest(dist, dim):
    """(best, second, argmin) along `dim`: the lowest index wins among equal
    minima and only the argmin slot is masked for the second best, so
    duplicates give second == best."""
    m1 = torch.amin(dist, dim=dim, keepdim=True)
    n = dist.shape[dim]
    shape = [1] * dist.dim()
    shape[dim] = n
    idx = torch.arange(n, device=dist.device, dtype=torch.int32).view(shape)
    arg = torch.amin(torch.where(dist == m1, idx, n), dim=dim, keepdim=True)
    m2 = torch.amin(torch.where(idx == arg, torch.inf, dist), dim=dim)
    return m1.squeeze(dim), m2, arg.squeeze(dim)


def streaming_top2_reference(d1, d2, a1, a2):
    """Plain PyTorch version of the K1 kernel.

    d1, d2 [P, N, D] bf16; a1, a2 [P, N] f32 = |d|^2 with +BIG on masked
    rows. The bf16 inputs are upcast to f32 before the product, which then
    equals the kernel's bf16 x bf16 -> f32 accumulation up to summation
    order. Returns (fwd_best1, fwd_best2, fwd_arg [P, N] into d2, rev_best1,
    rev_best2, rev_arg [P, N] into d1).
    """
    prod = d1.float() @ d2.float().mT  # [P, N, N]
    dist = torch.clamp(a1[:, :, None] + a2[:, None, :] - 2.0 * prod, min=0.0)
    big = torch.tensor(BIG, dtype=torch.float32, device=dist.device)
    fwd = _init_merge(*_top2_lowest(dist, 2), big)
    rev = _init_merge(*_top2_lowest(dist, 1), big)
    return (*fwd, *rev)


@functools.cache
def _kernel_lib():
    """The built kernel library with its C signatures declared."""
    lib = load_library(KERNEL)
    lib.streaming_top2_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
    )
    lib.streaming_top2_launch.restype = ctypes.c_int
    for size in ("k_chunk", "max_depth", "block_rows", "col_tile"):
        getattr(lib, f"streaming_top2_{size}").restype = ctypes.c_int
    return lib


def padded_norms(a, n_pad: int):
    """Norms [P, N] as the kernel reads them: [P, n_pad] f32 (n_pad a
    multiple of `COL_TILE`, at least N), +inf in the columns past N so that
    they never enter a top-2. The tensor itself when N == n_pad."""
    n = a.shape[1]
    return a if n == n_pad else F.pad(a, (0, n_pad - n), value=float("inf"))


def l2_bytes_per_launch(pairs: int, n: int, D: int) -> int:
    """Bytes one launch reads through L2, reckoned from the tile sizes: each
    block reads its [BLOCK_ROWS, D] bf16 slab once, and for every tile of
    `COL_TILE` columns the tile's bf16 rows and their f32 norms (the row
    norms, 4 bytes a row, are left out). The grid has a block for every
    `BLOCK_ROWS` rows of each pair in each of the two directions."""
    blocks = 2 * pairs * -(-n // BLOCK_ROWS)
    tiles = -(-n // COL_TILE)
    return blocks * (BLOCK_ROWS * D * 2 + tiles * COL_TILE * (D * 2 + 4))


def streaming_top2(d1, d2, a1, a2):
    """Fused both-direction top-2 over squared-L2 distances.

    d1, d2 [P, N, D] bf16 (on CUDA: contiguous, D a positive multiple of
    `K_CHUNK`, at most the kernel's resident depth, 640), a1/a2 [P, N] f32
    = |d|^2 with +BIG on masked rows.
    Returns (fwd_best1, fwd_best2, fwd_arg [P, N] into d2, rev_best1,
    rev_best2, rev_arg [P, N] into d1); args are int32.

    CPU tensors go to `streaming_top2_reference`; CUDA tensors launch the
    kernel (and count the launch in `streaming_top2.launches`). A barrier
    wait inside the kernel that does not end within 2 s traps: the launch
    then fails at the next synchronisation and the process's CUDA context
    is unusable from there on.
    """
    if not d1.is_cuda:
        return streaming_top2_reference(d1, d2, a1, a2)
    P, N, D = d1.shape
    for name, t, dtype, shape in (
        ("d1", d1, torch.bfloat16, (P, N, D)),
        ("d2", d2, torch.bfloat16, (P, N, D)),
        ("a1", a1, torch.float32, (P, N)),
        ("a2", a2, torch.float32, (P, N)),
    ):
        if t.device != d1.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"streaming_top2: {name} must be {dtype} {shape} on {d1.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"streaming_top2: {name} must be contiguous and 16-byte aligned")
    lib = _kernel_lib()
    kc, deepest = lib.streaming_top2_k_chunk(), lib.streaming_top2_max_depth()
    if D == 0 or D % kc or D > deepest:
        raise ValueError(
            f"streaming_top2: D={D} must be a positive multiple of {kc}, at most "
            f"{deepest} (the rows of a block stay in shared memory)"
        )
    if P == 0 or N == 0:
        raise ValueError("streaming_top2: empty batch")
    dev = d1.device
    f32, i32 = torch.float32, torch.int32
    fb1, fb2, rb1, rb2 = (torch.empty((P, N), dtype=f32, device=dev) for _ in range(4))
    fa, ra = (torch.empty((P, N), dtype=i32, device=dev) for _ in range(2))
    ldn = -(-N // COL_TILE) * COL_TILE
    a1, a2 = padded_norms(a1, ldn), padded_norms(a2, ldn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.streaming_top2_launch(
        d1.data_ptr(), d2.data_ptr(), a1.data_ptr(), a2.data_ptr(), P, N, D, ldn,
        fb1.data_ptr(), fb2.data_ptr(), fa.data_ptr(),
        rb1.data_ptr(), rb2.data_ptr(), ra.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"streaming_top2 kernel launch failed: CUDA error {err}")
    streaming_top2.launches += 1
    return fb1, fb2, fa, rb1, rb2, ra


streaming_top2.launches = 0


def streaming_inputs(d1, d2, mask1, mask2):
    """K1's inputs from descriptors [P, N, D] and masks [P, N]: (d1, d2 bf16
    with D zero-padded to a multiple of `K_CHUNK`, a1, a2 [P, N] f32 =
    |d|^2 of the f32 descriptors, +BIG on masked rows)."""
    D = d1.shape[-1]
    Dp = -(-D // K_CHUNK) * K_CHUNK
    d1 = d1.float()
    d2 = d2.float()
    if Dp != D:  # F.pad copies even when it pads nothing
        d1 = F.pad(d1, (0, Dp - D))
        d2 = F.pad(d2, (0, Dp - D))
    zero = torch.zeros((), dtype=torch.float32, device=d1.device)
    big = torch.tensor(BIG, dtype=torch.float32, device=d1.device)
    a1 = torch.sum(d1 * d1, dim=-1) + torch.where(mask1, zero, big)
    a2 = torch.sum(d2 * d2, dim=-1) + torch.where(mask2, zero, big)
    return (
        d1.to(torch.bfloat16).contiguous(), d2.to(torch.bfloat16).contiguous(), a1, a2
    )


def match_descriptors_batch_streaming(
    d1,  # [P, N, D]
    d2,  # [P, N, D]
    mask1,  # [P, N]
    mask2,  # [P, N]
    lowes_ratio: float,
    use_lowes_ratio: bool = True,
    keep_only_symmetric: bool = True,
):
    """Counterpart of `match_descriptors_batch_pallas`: the same semantics
    as `brute_force.match_descriptors_batch` on the fused kernel. Returns
    (match_idx [P, N] int32, distance [P, N] f32; BIG where unmatched)."""
    N = d1.shape[1]
    fb1, fb2, fa, rb1, rb2, ra = streaming_top2(*streaming_inputs(d1, d2, mask1, mask2))

    half_big = torch.tensor(BIG / 2, dtype=torch.float32, device=d1.device)
    ok = mask1 & (fb1 < half_big)
    ratio2 = torch.tensor(lowes_ratio, dtype=torch.float32, device=d1.device) ** 2
    if use_lowes_ratio:
        ok &= fb1 < ratio2 * fb2
    if keep_only_symmetric:
        ok_r = rb1 < half_big
        if use_lowes_ratio:
            ok_r &= rb1 < ratio2 * rb2
        fa_l = fa.long()
        rows = torch.arange(N, device=d1.device)[None, :]
        sym = (torch.gather(ra, 1, fa_l) == rows) & torch.gather(ok_r, 1, fa_l)
        ok &= sym
    return torch.where(ok, fa, -1).to(torch.int32), fb1
