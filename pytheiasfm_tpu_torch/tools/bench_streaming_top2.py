"""Time K1 (`streaming_top2`) on the card at the matcher's shapes.

    python -m pytheiasfm_tpu_torch.tools.bench_streaming_top2 [--pairs 8 496] [--iters N]

For each pair count P (N = 4096 descriptors of D = 128, the matcher's
width) it times the kernel by CUDA events after warm-up and prints its
time, its rate in the forward product's operations (2 P N^2 D; the kernel
does twice that, the reverse direction on the transposed product), its
share of the bound, and the bytes a launch reads through L2 as reckoned
from the tile sizes (`streaming_matcher.l2_bytes_per_launch`; not a
counter). Inputs are unit-norm random descriptors made on the card from a
seed.
"""

from __future__ import annotations

import argparse

import torch

from ..matching import streaming_matcher as sm
from ..utils.timing import cuda_time_ms

N, D = 4096, 128
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate of an H100 SXM


def inputs(pairs: int, seed: int = 0, n: int = N, depth: int = D):
    """Unit-norm descriptors on the card, d2 a noisy copy of d1, no masked
    rows, as K1 takes them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d1 = torch.randn((pairs, n, depth), generator=gen, device="cuda")
    d1 /= d1.norm(dim=-1, keepdim=True)
    d2 = d1 + 0.05 * torch.randn(d1.shape, generator=gen, device="cuda")
    d2 /= d2.norm(dim=-1, keepdim=True)
    ones = torch.ones((pairs, n), dtype=torch.bool, device="cuda")
    return sm.streaming_inputs(d1, d2, ones, ones)


def bench(pairs: int, iters: int) -> dict:
    """K1's time at P = `pairs`, with its rate, bound share and L2 bytes."""
    args = inputs(pairs)
    ms = cuda_time_ms(lambda: sm.streaming_top2(*args), iters=iters, warmup=2)
    ops = 2.0 * pairs * N * N * D
    bound_ms = 1e3 * ops / PEAK_BF16_FLOPS
    l2 = sm.l2_bytes_per_launch(pairs, N, D)
    row = dict(P=pairs, ms=ms, tflops=ops / ms / 1e9, bound_share=bound_ms / ms,
               l2_gb=l2 / 1e9, l2_tbs=l2 / ms / 1e9)
    print(f"[k1 bench] P={pairs} N={N} D={D}: {ms:.4f} ms, {row['tflops']:.1f} TF/s of the "
          f"forward product, {100 * row['bound_share']:.1f}% of the bound "
          f"({bound_ms:.4f} ms); {row['l2_gb']:.3f} GB through L2 a launch, reckoned from "
          f"the tile sizes ({row['l2_tbs']:.2f} TB/s implied; not a counter)", flush=True)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, nargs="+", default=[8, 496])
    parser.add_argument("--iters", type=int, default=20, help="timed launches per shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_streaming_top2: needs a CUDA card")
    for pairs in args.pairs:
        bench(pairs, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
