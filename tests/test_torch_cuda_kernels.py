"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker `cuda`) and skips without one. The
file imports neither JAX nor the JAX package, and needs nothing of
`tests/conftest.py`, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

K1's bars are those of `tests/test_torch_streaming_matcher.py`: indices
agree on at least 99.9% of rows (the two sum the bf16 products in another
order), distances to rtol = atol = 1e-5 where the indices agree; exact
duplicates must resolve by the tie rules exactly. K2's bar is that of
`tests/test_torch_exp_matcher_roofline.py`: max |delta| <= 1e-4 * (1 + |ref|).
The triangulation's chunked `eigh` is held here too, above the batch size
that cuSOLVER takes in one call.
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu_torch.matching import brute_force
from pytheiasfm_tpu_torch.matching import streaming_matcher as sm
from pytheiasfm_tpu_torch.ops import triangulation
from pytheiasfm_tpu_torch.tools import exp_matcher_roofline as k2

pytestmark = pytest.mark.cuda

BIG = 3.4e38


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the port's CUDA kernels run only on a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _descs(rng, P, N, D, noise=0.05):
    d1 = rng.normal(size=(P, N, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + rng.normal(size=d1.shape).astype(np.float32) * noise
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(N) for _ in range(P)])
    return d1, np.take_along_axis(d2, perm[:, :, None], axis=1)


def _masks(P, N):
    m1 = np.ones((P, N), bool)
    m2 = np.ones((P, N), bool)
    m1[:, -7:] = False
    m2[:, -3:] = False
    m1[0, 5] = False
    return m1, m2


def _kernel_inputs(d1, d2, m1, m2, device):
    a1 = np.sum(d1 * d1, -1) + np.where(m1, 0.0, BIG)
    a2 = np.sum(d2 * d2, -1) + np.where(m2, 0.0, BIG)
    return [
        torch.tensor(d1, device=device).bfloat16(),
        torch.tensor(d2, device=device).bfloat16(),
        torch.tensor(a1, dtype=torch.float32, device=device),
        torch.tensor(a2, dtype=torch.float32, device=device),
    ]


def _assert_top2_close(got, want, min_agree=0.999):
    got = [g.cpu().numpy() for g in got]
    want = [w.cpu().numpy() for w in want]
    for b1, b2, arg in ((0, 1, 2), (3, 4, 5)):
        agree = got[arg] == want[arg]
        assert agree.mean() >= min_agree, agree.mean()
        for k in (b1, b2):
            np.testing.assert_allclose(got[k][agree], want[k][agree], rtol=1e-5, atol=1e-5)
    return got


def _launch(args):
    before = sm.streaming_top2.launches
    out = sm.streaming_top2(*args)
    torch.cuda.synchronize()
    assert sm.streaming_top2.launches == before + 1
    return out


@pytest.mark.parametrize(
    "P,N,D",
    [(2, 64, 64), (2, 200, 128), (4, 1024, 128), (1, 4096, 128),
     # N not a multiple of the 128-row block or the 128-column tile; depths
     # from the shallowest to the deepest multiples of 64 below 640
     (3, 192, 192), (2, 320, 256), (3, 1000, 512), (2, 100, 64)],
)
def test_streaming_top2_matches_plain_version(cuda, rng, P, N, D):
    args = _kernel_inputs(*_descs(rng, P, N, D), *_masks(P, N), cuda)
    first = _launch(args)
    got = _assert_top2_close(first, sm.streaming_top2_reference(*args))
    # Masked rows come out as the TPU kernel's accumulator: (BIG, BIG, 0).
    assert got[0][0, 5] == np.float32(BIG) and got[2][0, 5] == 0
    # Two launches on the same inputs give the same bits.
    for a, b in zip(first, _launch(args)):
        assert torch.equal(a, b)


def _structured(P, N, D, low_at):
    """Inputs that turn a layout or merge mistake into an exact mismatch.
    Row i of `unit` is e_(i mod D); `ints` holds integers exact in bf16,
    64 + (j + 5 d) % 128, except one larger value per depth d, 200 + d % 32
    + 8 p, at row low_at[d] of pair p. With norms 0 for `unit` and 512 for
    `ints`, distance(i, j) = 512 - 2 ints[p, j, i mod D]: row i's minimum is
    at j = low_at[i mod D], and every distance is an integer."""
    i = np.arange(N)
    unit = np.zeros((P, N, D), np.float32)
    unit[:, i, i % D] = 1.0
    j, d = np.meshgrid(np.arange(N), np.arange(D), indexing="ij")
    ints = np.stack([(64 + (j + 5 * d) % 128).astype(np.float32)] * P)
    for p in range(P):
        ints[p, low_at, np.arange(D)] = 200 + np.arange(D) % 32 + 8 * p
    return unit, ints


@pytest.mark.parametrize("N,D", [(256, 64), (192, 128), (320, 128)])
@pytest.mark.parametrize("reverse", [False, True])
def test_streaming_top2_structured_inputs_are_exact(cuda, N, D, reverse):
    """The minimum placed in turn into every group of 8 (so at every one of
    the 128 positions of a block's rows and of a tile's columns: each row
    lane, both `acc_row` halves, each warp, both warpgroups, each half of a
    tile, a last tile of 64), in the forward direction (the row top-2, the
    minimum among the columns) or in the reverse one (the column top-2, the
    minimum among the rows). All six outputs equal the plain version's
    bits."""
    P = 2
    for group in range(N // 8):
        low_at = 8 * group + np.arange(D) % 8
        unit, ints = _structured(P, N, D, low_at)
        zeros = np.zeros((P, N), np.float32)
        norms = np.full((P, N), 512.0, np.float32)
        x = [torch.tensor(v, device=cuda).bfloat16() for v in (unit, ints)]
        z = [torch.tensor(v, device=cuda) for v in (zeros, norms)]
        args = [x[1], x[0], z[1], z[0]] if reverse else [x[0], x[1], z[0], z[1]]
        got = [g.cpu() for g in _launch(args)]
        want = sm.streaming_top2_reference(*[a.cpu() for a in args])
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), f"group {group}, output {k}"
        arg = got[5] if reverse else got[2]
        expect = torch.tensor(low_at[np.arange(N) % D], dtype=torch.int32)
        assert torch.equal(arg, expect.expand(P, N)), f"group {group}"


@pytest.mark.parametrize("N", [64, 192, 320])
def test_streaming_top2_tails_do_not_read_the_next_pair(cuda, rng, N):
    """A block's rows and a tile's columns past N lie in the next pair's
    rows. Pair 1's d2 holds pair 0's d1, and pair 2's d1 holds pair 1's d2:
    a column past N read into pair 0's forward or pair 1's reverse top-2
    would be at distance 0 and win."""
    P, D = 3, 128
    d1, d2 = _descs(rng, P, N, D)
    d2[1] = d1[0]
    d1[2] = d2[1]
    ones = np.ones((P, N), bool)
    args = _kernel_inputs(d1, d2, ones, ones, cuda)
    got = _assert_top2_close(_launch(args), sm.streaming_top2_reference(*args))
    assert got[0][0].min() > 1e-2 and got[3][1].min() > 1e-2


def test_streaming_top2_duplicates_keep_the_lowest_index(cuda, rng):
    """Exact duplicates of d2 rows (columns of the forward product) and of
    d1 rows (rows of it): in one quad, across the two halves of a tile,
    across tiles, across warpgroups and across blocks of rows. The lowest
    index wins and the second best equals the best."""
    P, N, D = 2, 384, 128
    d1 = rng.normal(size=(P, N, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + 0.05 * rng.normal(size=d1.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)  # row i's match is row i
    dups = ((8, 9), (20, 84), (7, 140), (3, 70), (5, 300))
    for lo, hi in dups:
        d2[:, hi] = d2[:, lo]
        d1[:, hi] = d1[:, lo]
    ones = np.ones((P, N), bool)
    args = _kernel_inputs(d1, d2, ones, ones, cuda)
    got = _assert_top2_close(_launch(args), sm.streaming_top2_reference(*args), min_agree=1.0)
    for b1, b2, arg in ((0, 1, 2), (3, 4, 5)):
        for lo, hi in dups:
            assert np.all(got[arg][:, [lo, hi]] == lo) and not np.any(got[arg] == hi)
            np.testing.assert_array_equal(got[b2][:, [lo, hi]], got[b1][:, [lo, hi]])


def test_streaming_top2_masked_rows_and_columns(cuda, rng):
    """A pair whose d1 rows are all masked gives (BIG, BIG, 0) in both
    directions; masked d2 rows never win a forward top-2."""
    P, N, D = 2, 256, 128
    d1, d2 = _descs(rng, P, N, D)
    m1 = np.ones((P, N), bool)
    m2 = np.ones((P, N), bool)
    m1[1] = False
    m2[0, ::2] = False
    args = _kernel_inputs(d1, d2, m1, m2, cuda)
    got = _assert_top2_close(_launch(args), sm.streaming_top2_reference(*args))
    for b1, b2, arg in ((0, 1, 2), (3, 4, 5)):
        assert np.all(got[b1][1] == np.float32(BIG)) and np.all(got[b2][1] == np.float32(BIG))
        assert np.all(got[arg][1] == 0)
    assert np.all(got[2][0] % 2 == 1) and np.all(got[0][0] < BIG / 2)
    # The reverse top-2 of a masked column is (BIG, BIG, 0).
    assert np.all(got[3][0, ::2] == np.float32(BIG)) and np.all(got[5][0, ::2] == 0)


def test_streaming_top2_tie_rules(cuda, rng):
    """Exact duplicates within one 64-row tile and across tiles: the lowest
    index wins and the second best equals the best."""
    P, N, D = 1, 256, 128
    d1, d2 = _descs(rng, P, N, D)
    d2[0, 140] = d2[0, 7]
    d2[0, 9] = d2[0, 8]
    d1[0, 200] = d1[0, 3]
    ones = np.ones((P, N), bool)
    args = _kernel_inputs(d1, d2, ones, ones, cuda)
    got = _assert_top2_close(_launch(args), sm.streaming_top2_reference(*args), min_agree=1.0)
    for lo, hi in ((7, 140), (8, 9)):
        rows = np.flatnonzero(got[2][0] == lo)
        assert len(rows) and not np.any(got[2][0] == hi)
        np.testing.assert_array_equal(got[1][0, rows], got[0][0, rows])
    rows = np.flatnonzero(got[5][0] == 3)
    assert len(rows) and not np.any(got[5][0] == 200)
    np.testing.assert_array_equal(got[4][0, rows], got[3][0, rows])


def test_streaming_top2_rejects_bad_inputs(cuda, rng):
    args = _kernel_inputs(*_descs(rng, 1, 64, 64), *_masks(1, 64), cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        sm.streaming_top2(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="multiple"):
        sm.streaming_top2(args[0][..., :48].contiguous(), args[1][..., :48].contiguous(),
                          *args[2:])
    # The deepest contraction that stays resident in shared memory runs; the
    # next multiple of 64 is refused by name.
    lib = sm._kernel_lib()
    deepest = lib.streaming_top2_max_depth()
    assert deepest >= 512
    for D, run in ((deepest, True), (deepest + 64, False)):
        deep = _kernel_inputs(*_descs(rng, 1, 128, D), *_masks(1, 128), cuda)
        if run:
            _assert_top2_close(_launch(deep), sm.streaming_top2_reference(*deep))
        else:
            with pytest.raises(ValueError, match=f"D={D}"):
                sm.streaming_top2(*deep)


def test_streaming_top2_tile_sizes_match_the_wrapper(cuda):
    """The grid and the L2 bytes the wrapper reckons use the kernel's own
    tile sizes."""
    lib = sm._kernel_lib()
    assert lib.streaming_top2_block_rows() == sm.BLOCK_ROWS
    assert lib.streaming_top2_col_tile() == sm.COL_TILE
    assert lib.streaming_top2_k_chunk() == sm.K_CHUNK


@pytest.mark.parametrize("N,D", [(64, 128), (256, 32)])
def test_matcher_dispatch_launches_the_kernel(cuda, rng, N, D):
    """`match_descriptors_batch_auto` on CUDA tensors runs K1 (D padded to
    the kernel's chunk) and agrees with the plain matcher run on the CPU."""
    d1, d2 = _descs(rng, 2, N, D)
    m1, m2 = _masks(2, N)
    cpu = [torch.tensor(x) for x in (d1, d2, m1, m2)]
    before = sm.streaming_top2.launches
    idx, _ = brute_force.match_descriptors_batch_auto(*[x.to(cuda) for x in cpu], 0.8)
    assert sm.streaming_top2.launches == before + 1
    want, _ = brute_force.match_descriptors_batch_auto(*cpu, 0.8)
    agree = (idx.cpu() == want).float().mean().item()
    assert agree >= 0.999, agree
    assert (want >= 0).sum() > 0.5 * m1.sum()


def _launch_rowmin(d1, d2t):
    before = k2.matmul_rowmin.launches
    got = k2.matmul_rowmin(d1, d2t)
    torch.cuda.synchronize()
    assert k2.matmul_rowmin.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == d1.shape[:2]
    return got


@pytest.mark.parametrize(
    "P,N,D",
    [(1, 64, 64), (2, 128, 128), (3, 512, 256), (2, 1024, 512),
     # one step of columns and less; an odd multiple of 64; the deepest
     # and the shallowest contraction over several blocks of rows
     (3, 64, 512), (2, 192, 128), (2, 320, 64), (1, 4096, 64), (9, 384, 512)],
)
def test_matmul_rowmin_matches_plain_version(cuda, P, N, D):
    d1, d2t = k2.inputs(D, seed=N + D, device=cuda, pairs=P, n=N)
    got = _launch_rowmin(d1, d2t)
    want = k2.matmul_rowmin_reference(d1, d2t)
    assert torch.all((got - want).abs() <= 1e-4 * (1 + want.abs()))
    # Two launches on the same inputs give the same bits.
    assert torch.equal(got, _launch_rowmin(d1, d2t))


@pytest.mark.parametrize("N", [64, 192, 448])
def test_matmul_rowmin_tail_columns_do_not_win(cuda, rng, N):
    """N an odd multiple of 64 with every product positive: a column past N
    that the kernel read as zeros would be each row's minimum."""
    P, D = 2, 128
    d1 = torch.tensor(np.abs(rng.normal(size=(P, N, D))) + 0.5, device=cuda).bfloat16()
    d2t = torch.tensor(np.abs(rng.normal(size=(P, D, N))) + 0.5, device=cuda).bfloat16()
    got = _launch_rowmin(d1, d2t)
    want = k2.matmul_rowmin_reference(d1, d2t)
    assert got.min() > 0.25 * D
    assert torch.all((got - want).abs() <= 1e-4 * (1 + want.abs()))


@pytest.mark.parametrize("N,D", [(256, 64), (192, 128), (384, 256)])
def test_matmul_rowmin_structured_inputs_are_exact(cuda, N, D):
    """Inputs that turn a layout mistake into an exact mismatch. Row i of d1
    is the unit vector e_(i mod D), so out[p, i] = min_j d2t[p, i mod D, j].
    d2t holds integers exact in bf16, 64 + (j + 5 d) % 128, except one
    smaller value per depth row, 1 + d % 16 + 16 p, at a known column that is
    put in turn into every group of 8 columns (so also into each half of a
    128-column step, and into a last step of 64)."""
    P = 2
    i = np.arange(N)
    d1 = np.zeros((P, N, D), np.float32)
    d1[:, i, i % D] = 1.0
    d, j = np.meshgrid(np.arange(D), np.arange(N), indexing="ij")
    base = (64 + (j + 5 * d) % 128).astype(np.float32)
    low = 1 + np.arange(D) % 16
    want = np.stack([low[i % D] + 16 * p for p in range(P)]).astype(np.float32)
    d1 = torch.tensor(d1, device=cuda).bfloat16()
    for group in range(N // 8):
        d2t = np.stack([base, base])
        cols = 8 * group + np.arange(D) % 8
        for p in range(P):
            d2t[p, np.arange(D), cols] = low + 16 * p
        got = _launch_rowmin(d1, torch.tensor(d2t, device=cuda).bfloat16())
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=f"group {group}")


def test_matmul_rowmin_rejects_bad_shapes(cuda):
    d1, d2t = k2.inputs(128, device=cuda, pairs=1, n=128)
    with pytest.raises(ValueError, match="N=96"):
        k2.matmul_rowmin(d1[:, :96].contiguous(), d2t[..., :96].contiguous())
    with pytest.raises(ValueError, match="D=96"):
        k2.matmul_rowmin(d1[..., :96].contiguous(), d2t[:, :96].contiguous())
    # The deepest contraction that stays resident in shared memory runs; the
    # next multiple of 64 is refused by name.
    deepest = k2._kernel_lib().matmul_rowmin_max_depth()
    assert deepest >= 512
    deep1, deep2t = k2.inputs(deepest, device=cuda, pairs=1, n=128)
    want = k2.matmul_rowmin_reference(deep1, deep2t)
    assert torch.all((_launch_rowmin(deep1, deep2t) - want).abs() <= 1e-4 * (1 + want.abs()))
    over1, over2t = k2.inputs(deepest + 64, device=cuda, pairs=1, n=128)
    with pytest.raises(ValueError, match=f"D={deepest + 64}"):
        k2.matmul_rowmin(over1, over2t)
    with pytest.raises(ValueError, match="bfloat16"):
        k2.matmul_rowmin(d1.float(), d2t)
    with pytest.raises(ValueError, match="contiguous"):
        k2.matmul_rowmin(d1, d2t.mT.contiguous().mT)


def test_eigh_in_chunks_above_the_cusolver_batch(cuda):
    """`_eigh` over [2, _EIGH_BATCH + 8, 4, 4] symmetric matrices (cuSOLVER
    refuses such a batch in one call): eigenvalues against f64 on the CPU,
    and V diag(w) V^T against the input, to 1e-4 * (1 + max |a|)."""
    gen = torch.Generator().manual_seed(3)
    b = torch.randn(2, triangulation._EIGH_BATCH + 8, 4, 4, generator=gen)
    a = b @ b.mT
    vals, vecs = triangulation._eigh(a.to(cuda))
    assert vals.shape == a.shape[:-1] and vecs.shape == a.shape
    tol = 1e-4 * (1 + a.abs().amax())
    want = torch.linalg.eigvalsh(a.double()).float()
    assert torch.all((vals.cpu() - want).abs() <= tol)
    back = (vecs * vals[..., None, :]) @ vecs.mT
    assert torch.all((back.cpu() - a).abs() <= tol)
