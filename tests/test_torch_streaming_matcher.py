"""K1 parity: the port's streaming matcher (`pytheiasfm_tpu_torch/matching/
streaming_matcher.py`) against the JAX package's Pallas kernel run in
interpret mode on the CPU, as `tests/test_pallas_matcher.py` runs it.

Tolerances: indices agree on at least 99.9% of rows (the two sum the bf16
products in another order, and under x64 the JAX wrapper forms distances
in f64, so a near-tie can flip); distances agree to rtol = atol = 1e-5
where the indices agree (distances are O(1), the summation-order error is
~1e-7). The CUDA kernel itself runs only on the card: its tests, against
this plain version, are in `tests/test_torch_cuda_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.matching.pallas_matcher import (
    match_descriptors_batch_pallas,
    streaming_top2 as jax_streaming_top2,
)
from pytheiasfm_tpu_torch.matching import streaming_matcher as sm

BIG = 3.4e38


def _descs(rng, P, N, D, noise=0.05):
    base = rng.normal(size=(P, N, D)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    d2 = base + rng.normal(size=base.shape).astype(np.float32) * noise
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(N) for _ in range(P)])
    return base, np.take_along_axis(d2, perm[:, :, None], axis=1)


def _masks(P, N):
    m1 = np.ones((P, N), bool)
    m2 = np.ones((P, N), bool)
    m1[:, -7:] = False
    m2[:, -3:] = False
    m1[0, 5] = False
    return m1, m2


def _kernel_inputs(d1, d2, m1, m2):
    """The kernel's inputs as f32 numpy: bf16-rounded descriptors and f32
    norms (+BIG on masked rows)."""
    a1 = (np.sum(d1 * d1, -1) + np.where(m1, 0.0, BIG)).astype(np.float32)
    a2 = (np.sum(d2 * d2, -1) + np.where(m2, 0.0, BIG)).astype(np.float32)
    b1 = torch.tensor(d1).bfloat16()
    b2 = torch.tensor(d2).bfloat16()
    return b1, b2, a1, a2


def _jax_top2(b1, b2, a1, a2, tile=128):
    out = jax_streaming_top2(
        jnp.asarray(b1.float().numpy(), jnp.bfloat16),
        jnp.swapaxes(jnp.asarray(b2.float().numpy(), jnp.bfloat16), 1, 2),
        jnp.asarray(a1),
        jnp.asarray(a2),
        tile_i=tile,
        tile_j=tile,
        interpret=True,
    )
    return [np.asarray(o) for o in out]


def _assert_top2_close(got, want, min_agree=0.999):
    """Six outputs: (best1, best2, arg) forward then reverse."""
    for b1, b2, arg in ((0, 1, 2), (3, 4, 5)):
        agree = got[arg] == want[arg]
        assert agree.mean() >= min_agree, agree.mean()
        for k in (b1, b2):
            np.testing.assert_allclose(got[k][agree], want[k][agree], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [128, 256])
def test_reference_matches_pallas_interpret(rng, N):
    P, D = 2, 128
    d1, d2 = _descs(rng, P, N, D)
    b1, b2, a1, a2 = _kernel_inputs(d1, d2, *_masks(P, N))
    want = _jax_top2(b1, b2, a1, a2)
    got = sm.streaming_top2_reference(b1, b2, torch.tensor(a1), torch.tensor(a2))
    got = [g.numpy() for g in got]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    _assert_top2_close(got, want)
    # Masked rows come out as the TPU kernel's accumulator: (BIG, BIG, 0).
    assert got[0][0, 5] == np.float32(BIG) and got[2][0, 5] == 0


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("ratio_and_symmetric", [True, False])
def test_wrapper_matches_pallas_wrapper(rng, D, ratio_and_symmetric):
    P, N = 2, 256
    d1, d2 = _descs(rng, P, N, D)
    m1, m2 = _masks(P, N)
    flags = dict(
        use_lowes_ratio=ratio_and_symmetric, keep_only_symmetric=ratio_and_symmetric
    )
    idx_j, dist_j = match_descriptors_batch_pallas(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        jnp.asarray(0.8, jnp.float32), tile_i=128, tile_j=128, interpret=True,
        **flags,
    )
    idx_t, dist_t = sm.match_descriptors_batch_streaming(
        torch.tensor(d1), torch.tensor(d2), torch.tensor(m1), torch.tensor(m2),
        0.8, **flags,
    )
    idx_j, dist_j = np.asarray(idx_j), np.asarray(dist_j)
    idx_t, dist_t = idx_t.numpy(), dist_t.numpy()
    agree = idx_t == idx_j
    assert agree.mean() >= 0.999, agree.mean()
    assert (idx_t >= 0).sum() > 0.5 * m1.sum()
    sel = agree & (idx_t >= 0)
    np.testing.assert_allclose(dist_t[sel], dist_j[sel], rtol=1e-5, atol=1e-5)


def test_tie_rules_on_duplicates(rng):
    """Exact duplicates exercise the three tie rules: the lowest index wins
    inside a tile and across tiles, and best2 == best1 for a duplicate."""
    P, N, D = 1, 256, 128
    d1, d2 = _descs(rng, P, N, D)
    d2[0, 140] = d2[0, 7]  # duplicate columns in two tiles (tile 128)
    d2[0, 9] = d2[0, 8]  # duplicate columns in one tile
    d1[0, 200] = d1[0, 3]  # duplicate rows in two tiles
    m1 = np.ones((P, N), bool)
    b1, b2, a1, a2 = _kernel_inputs(d1, d2, m1, m1)
    want = _jax_top2(b1, b2, a1, a2)
    got = [g.numpy() for g in sm.streaming_top2_reference(
        b1, b2, torch.tensor(a1), torch.tensor(a2))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[5], want[5])
    _assert_top2_close(got, want, min_agree=1.0)
    # The rows of d1 nearest to the duplicated columns pick the lower index
    # and see a second best equal to the best.
    for lo, hi in ((7, 140), (8, 9)):
        rows = np.flatnonzero(got[2][0] == lo)
        assert len(rows) and not np.any(got[2][0] == hi)
        np.testing.assert_array_equal(got[1][0, rows], got[0][0, rows])
    rev_rows = np.flatnonzero(got[5][0] == 3)
    assert len(rev_rows) and not np.any(got[5][0] == 200)
    np.testing.assert_array_equal(got[4][0, rev_rows], got[3][0, rev_rows])


def test_cpu_tensors_take_the_plain_version(rng):
    d1, d2 = _descs(rng, 1, 64, 64)
    b1, b2, a1, a2 = _kernel_inputs(d1, d2, *_masks(1, 64))
    before = sm.streaming_top2.launches
    out = sm.streaming_top2(b1, b2, torch.tensor(a1), torch.tensor(a2))
    ref = sm.streaming_top2_reference(b1, b2, torch.tensor(a1), torch.tensor(a2))
    assert sm.streaming_top2.launches == before
    for o, r in zip(out, ref):
        assert torch.equal(o, r)



@pytest.mark.parametrize(
    "P,N,D,l2_bytes",
    [
        # 32 blocks of 128 rows x 8 pairs x 2 directions, each reading a
        # 32 KB slab and 32 tiles of 128 x (256 + 4) bytes: 1,097,728 bytes
        (8, 4096, 128, 512 * 1_097_728),
        (496, 4096, 128, 31_744 * 1_097_728),
        # N past a block and a tile: 2 blocks a pair and direction, each
        # reading a 16 KB slab and 2 tiles of 128 x (128 + 4) bytes
        (2, 200, 64, 8 * (16_384 + 2 * 128 * 132)),
    ],
)
def test_l2_bytes_per_launch_by_hand(P, N, D, l2_bytes):
    assert sm.l2_bytes_per_launch(P, N, D) == l2_bytes


def test_padded_norms_leave_the_plain_version_unchanged(rng):
    """The wrapper pads each pair's norms to whole tiles of columns with
    +inf, and the kernel reads descriptors past N from the next pair. The
    plain version on inputs padded so (extra rows that copy the other side,
    at distance 0 if they counted), sliced to N, equals it on the unpadded
    inputs bit for bit, with masked rows and duplicate ties."""
    P, N, D = 2, 200, 64
    n_pad = -(-N // sm.COL_TILE) * sm.COL_TILE
    d1, d2 = _descs(rng, P, N, D)
    d2[:, 9] = d2[:, 8]
    d1[:, 150] = d1[:, 3]
    b1, b2, a1, a2 = _kernel_inputs(d1, d2, *_masks(P, N))
    a1, a2 = torch.tensor(a1), torch.tensor(a2)
    want = sm.streaming_top2_reference(b1, b2, a1, a2)
    extra = n_pad - N
    p1 = torch.cat([b1, b2[:, :extra]], 1)
    p2 = torch.cat([b2, b1[:, :extra]], 1)
    q1, q2 = sm.padded_norms(a1, n_pad), sm.padded_norms(a2, n_pad)
    assert q1.shape == (P, n_pad) and torch.all(torch.isinf(q1[:, N:]))
    assert torch.equal(q1[:, :N], a1) and sm.padded_norms(q1, n_pad) is q1
    got = sm.streaming_top2_reference(p1, p2, q1, q2)
    for g, w in zip(got, want):
        assert torch.equal(g[:, :N], w)
