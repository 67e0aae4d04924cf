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
that cuSOLVER takes in one call, and steps 1-7 of global SfM (no
hand-written kernel; eager PyTorch in f64) on a small contaminated scene,
card against CPU: the same edge sets, orientations within 1e-7 rad,
positions within 1e-7 x the median radius. The main path's iterative-Schur
bundle adjustment and `estimate` (eager PyTorch, no hand-written kernel):
BA at the reference-default options on a small reconstruction, card against
CPU, final cost to 1e-4 relative (f32, sums in another order); `estimate`
on the 8-view scene of `tests/test_global_estimator.py`, the same estimated
views on the card as on the CPU. The dense-Schur and flat kernels (with and
without view priors) and the covariance entries, card against CPU: f64 the
same LM iterations, the final cost and the covariance blocks to 1e-8
relative; f32 the final cost to 1e-4 relative. The f64 bars for BA over a
rig of all eight camera models in one problem (`tools.camera_rig`). The six
estimators of the remaining minimal solvers, scored on the same samples,
card against CPU (f64): inliers on 99.5% of rows, models to 1e-6. The
Sim(3) pose graph (f64) and MVS view selection (f32 angles, f64 sums),
card against CPU: nodes and cost to 1e-8 relative; the same neighbour
lists, scores to 1e-4 relative.
"""

import copy


import numpy as np
import pytest
import torch

from pytheiasfm_tpu_torch.matching import brute_force
from pytheiasfm_tpu_torch.matching import streaming_matcher as sm
from pytheiasfm_tpu_torch.ops import triangulation
from pytheiasfm_tpu_torch.ops.rotation_np import (
    angle_axis_to_rotation_matrix_np,
    rotation_matrix_to_angle_axis_np,
)
from pytheiasfm_tpu_torch.ba import entry as ba_entry
from pytheiasfm_tpu_torch.pipelines.synthetic_global import build_scene
from pytheiasfm_tpu_torch.sfm import estimator_options
from pytheiasfm_tpu_torch.sfm.global_estimator import GlobalReconstructionEstimator
from pytheiasfm_tpu_torch.utils import synthetic
from pytheiasfm_tpu_torch.tools import exp_matcher_roofline as k2
from pytheiasfm_tpu_torch.tools import global_pose

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


def test_global_pose_steps_on_the_card_match_the_cpu(cuda):
    """Steps 1-7 on the 48-view scene with 15% of its edges corrupted."""
    recon, graph, _ = build_scene(V=48, T=4000, neighborhood=6)
    bad = global_pose.contaminate(graph)
    runs = [
        global_pose.run_global_pose(copy.deepcopy(graph), copy.deepcopy(recon), device=device)
        for device in (cuda, "cpu")
    ]
    card, cpu = runs
    assert card.edges == cpu.edges and card.removed == cpu.removed
    assert card.removed["orientation filter"] == len(bad)
    ids = sorted(cpu.positions)
    assert sorted(card.positions) == ids and len(ids) == 48
    R_card = angle_axis_to_rotation_matrix_np(np.stack([card.orientations[v] for v in ids]))
    R_cpu = angle_axis_to_rotation_matrix_np(np.stack([cpu.orientations[v] for v in ids]))
    angles = np.linalg.norm(rotation_matrix_to_angle_axis_np(R_card @ R_cpu.transpose(0, 2, 1)), axis=-1)
    assert angles.max() <= 1e-7
    p_card = np.stack([card.positions[v] for v in ids])
    p_cpu = np.stack([cpu.positions[v] for v in ids])
    radius = np.median(np.linalg.norm(p_cpu - p_cpu.mean(0), axis=-1))
    assert np.linalg.norm(p_card - p_cpu, axis=-1).max() <= 1e-7 * radius


def test_bundle_adjustment_and_estimate_on_the_card_match_the_cpu(cuda):
    """The main path's BA and `estimate`, card against CPU."""
    recon = synthetic.random_reconstruction(num_views=8, num_tracks=150, seed=5, pixel_noise=0.3)
    gen = np.random.default_rng(9)
    recon.view_extrinsics[1:, :3] += gen.normal(size=(7, 3)) * 0.02
    recon.points[:, :3] += gen.normal(size=(150, 3)) * 0.02
    recon.intrinsics[:, 0] *= 1.01
    recon.view_group[:] = 0
    options = estimator_options.set_bundle_adjustment_options(
        estimator_options.ReconstructionEstimatorOptions(), 8)
    summaries = []
    for device in (cuda, "cpu"):
        r = copy.deepcopy(recon)
        summaries.append(ba_entry.bundle_adjust_reconstruction(options, r, device=device))
    card, cpu = summaries
    assert card.success and cpu.success and card.final_cost < 0.05 * card.initial_cost
    assert abs(card.final_cost - cpu.final_cost) <= 1e-4 * cpu.final_cost

    scene, gt_ext, _ = synthetic.generate_scene(
        synthetic.SyntheticSceneOptions(num_views=8, num_tracks=150, pixel_noise=0.3, seed=7))
    graph = synthetic.add_view_graph_edges(scene, gt_ext, min_shared_tracks=20,
                                           rotation_noise_degrees=1.0,
                                           position_noise_degrees=1.0, seed=3)
    opt = estimator_options.ReconstructionEstimatorOptions(min_num_two_view_inliers=20)
    runs = [GlobalReconstructionEstimator(opt, device=device).estimate(
        copy.deepcopy(graph), copy.deepcopy(scene)) for device in (cuda, "cpu")]
    assert runs[0].success and runs[1].success
    assert runs[0].estimated_views == runs[1].estimated_views
    assert len(runs[0].estimated_views) == 8


def _perturbed_reconstruction():
    recon = synthetic.random_reconstruction(num_views=8, num_tracks=150, seed=5, pixel_noise=0.3)
    gen = np.random.default_rng(9)
    recon.view_extrinsics[1:, :3] += gen.normal(size=(7, 3)) * 0.02
    recon.points[:, :3] += gen.normal(size=(150, 3)) * 0.02
    for v in range(8):
        recon.view_priors[v].position = recon.view_extrinsics[v, :3] + gen.normal(size=3) * 0.01
        recon.view_priors[v].position_sqrt_information = np.eye(3) * 100.0
    return recon


@pytest.mark.parametrize("route,changes", [
    ("dense", {}),
    ("dense", dict(use_position_priors=True)),
    ("flat", dict(track_parametrization_type=2)),  # INVERSE_DEPTH
    ("flat", dict(track_parametrization_type=2, use_position_priors=True)),
])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_and_flat_bundle_adjustment_on_the_card_match_the_cpu(cuda, route, changes, dtype):
    """The calibrated defaults (dense Schur) and INVERSE_DEPTH tracks (flat
    kernel), with and without position priors, card against CPU: the same
    kernel; f64 the same LM iterations and the final cost to 1e-8 relative,
    f32 the final cost to 1e-4 relative (sums in another order)."""
    from pytheiasfm_tpu_torch.ba.lm import BundleAdjustmentOptions, TrackParametrizationType

    if "track_parametrization_type" in changes:
        changes = dict(changes, track_parametrization_type=TrackParametrizationType(2))
    options = BundleAdjustmentOptions(**changes)
    recon = _perturbed_reconstruction()
    summaries, states = [], []
    for device in (cuda, "cpu"):
        r = copy.deepcopy(recon)
        summaries.append(ba_entry.bundle_adjust_reconstruction(options, r, dtype, device=device))
        states.append(r)
    card, cpu = summaries
    assert card.linear_solver == cpu.linear_solver == route
    assert card.success and cpu.success and card.final_cost < 0.5 * card.initial_cost
    if dtype == np.float64:
        assert card.num_iterations == cpu.num_iterations
        assert abs(card.final_cost - cpu.final_cost) <= 1e-8 * cpu.final_cost
        np.testing.assert_allclose(states[0].view_extrinsics, states[1].view_extrinsics,
                                   rtol=0, atol=1e-6)
    else:
        assert abs(card.final_cost - cpu.final_cost) <= 1e-4 * cpu.final_cost


@pytest.mark.parametrize("selected", [False, True])
def test_covariance_on_the_card_matches_the_cpu(cuda, selected):
    """`compute_reconstruction_covariance` (f64), the dense inverse and the
    selected-block PCG, card against CPU: every block and the variance
    factor to 1e-8 relative of the largest entry."""
    from pytheiasfm_tpu_torch.ba.lm import BundleAdjustmentOptions

    recon = _perturbed_reconstruction()
    ba_entry.bundle_adjust_reconstruction(BundleAdjustmentOptions(), recon, np.float64,
                                          device="cpu")
    kw = dict(view_ids=[2, 5], track_ids=[3, 40]) if selected else {}
    card, cpu = (ba_entry.compute_reconstruction_covariance(
        BundleAdjustmentOptions(), recon, constant_views=(0, 1), device=device, **kw)
        for device in (cuda, "cpu"))
    assert abs(card[2] - cpu[2]) <= 1e-8 * cpu[2]
    for got, want in zip(card[:2], cpu[:2]):
        assert set(got) == set(want) and want
        scale = max(np.abs(w).max() for w in want.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8 * scale)


def test_mixed_rig_bundle_adjustment_on_the_card_matches_the_cpu(cuda):
    """The eight-model rig of `tools.camera_rig` at 6 views and 40 tracks a
    model (each observation projected through its own model,
    `ba/lm._pixel_of`), free focal length and radial distortion (the
    iterative Schur), in the rig's f64, card against CPU: the same LM
    iterations and the final cost to 1e-8 relative; then the outlier
    filter's reprojection pass over the rig to 1e-6 px^2. Not in f32: there
    the rig's final cost moves by 1e-3 relative under a 1e-7 change of the
    points on the CPU alone (the f32 LM stop falls on rounding noise; the
    ORTHOGRAPHIC group's pixels reach 1e5)."""
    from pytheiasfm_tpu_torch.sfm import reconstruction_estimator_utils as reu
    from pytheiasfm_tpu_torch.tools import camera_rig

    rig = camera_rig.build_rig(views_per_group=6, tracks_per_group=40)
    free = camera_rig.perturb(rig)
    tracks = [int(t) for t in np.nonzero(rig.recon.track_estimated)[0]]
    summaries, states = [], []
    for device in (cuda, "cpu"):
        r = copy.deepcopy(rig.recon)
        summaries.append(ba_entry.bundle_adjust_partial_reconstruction(
            camera_rig.RIG_OPTIONS, free, tracks, r, camera_rig.RIG_DTYPE, device=device))
        states.append(r)
    card, cpu = summaries
    assert card.linear_solver == cpu.linear_solver == "iterative"
    assert card.success and cpu.success and card.final_cost < 0.01 * card.initial_cost
    assert card.num_iterations == cpu.num_iterations
    assert abs(card.final_cost - cpu.final_cost) <= 1e-8 * cpu.final_cost
    errs = [reu.compute_reprojection_errors(states[1], device=device)[0]
            for device in (cuda, "cpu")]
    np.testing.assert_allclose(errs[0], errs[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["p4pf", "p4pfr", "similarity", "rigid", "plane",
                                  "radial_homography"])
def test_minimal_solver_estimators_on_the_card_match_the_cpu(cuda, name):
    """Each estimator of the remaining minimal solvers (`tools.minimal_solvers`'
    problems at 16 views, f64) scored on the same 64 samples a problem
    (`engine.score_samples`, indices drawn once on the CPU), card against
    CPU: every problem's best inlier count equal, the inlier masks on 99.5%
    of rows, and the best models to 1e-6 relative on 14 of the 16 problems
    (the homography up to its sign). Where several hypotheses tie on the
    best count, which comes first can be the rounding's: the focal solvers
    keep 4 of up to 28 candidates a sample, and where more converge, which
    fill the slots is the rounding's."""
    from pytheiasfm_tpu_torch.ransac import engine
    from pytheiasfm_tpu_torch.tools import minimal_solvers

    prob = minimal_solvers.build_problems(V=16, T=2000)[name]
    params = engine.RansacParameters(max_iterations=64, min_iterations=64)
    runs, idx = [], None
    for device in ("cpu", cuda):
        est, data, mask, thresh = minimal_solvers.estimator_and_data(
            name, prob, device, torch.float64)
        if idx is None:
            idx = engine._draw_samples(torch.Generator().manual_seed(0), mask, 64,
                                       est.sample_size)
        runs.append(engine.score_samples(idx.to(device), data, est, params, mask=mask,
                                         error_thresh=thresh))
    (cpu_model, cpu_sum), (card_model, card_sum) = runs
    assert torch.equal(card_sum.num_inliers.cpu(), cpu_sum.num_inliers), (
        card_sum.num_inliers, cpu_sum.num_inliers)
    agree = (card_sum.inliers.cpu() == cpu_sum.inliers).float().mean()
    assert agree >= 0.995, agree
    assert int(cpu_sum.num_inliers.sum()) > 0
    P = cpu_sum.num_inliers.shape[0]
    same = np.ones(P, bool)
    for a, b in zip(card_model, cpu_model):
        a, b = a.cpu().numpy().reshape(P, -1), b.numpy().reshape(P, -1)
        if name == "radial_homography" and a.shape[1] == 9:
            # H is an eigenvector's: its sign is the eigen-solver's.
            a = a * np.sign(np.sum(a * b, axis=1))[:, None]
        same &= np.all(np.abs(a - b) <= 1e-6 * np.maximum(1.0, np.abs(b)), axis=1)
    assert same.sum() >= P - 2, same


def test_sim3_pose_graph_on_the_card_matches_the_cpu(cuda):
    """`optimize_sim3_pose_graph` on `tools.file_scene`'s pose graph at 64
    views (about 1,300 self edges, node 0 fixed), 20 Gauss-Newton steps in
    f64, card against CPU: nodes and the final cost to 1e-8 relative."""
    from pytheiasfm_tpu_torch.tools import file_scene
    from pytheiasfm_tpu_torch.transforms import optimize_sim3_pose_graph

    _, gt, graph = file_scene.scene(V=64, T=6000)
    init, self_edges, cross_edges, fixed, gt_nodes = file_scene.pose_graph_problem(gt, graph)
    runs = [optimize_sim3_pose_graph(init, self_edges, cross_edges, fixed, 20, device=d)
            for d in ("cpu", cuda)]
    (cpu_nodes, cpu_cost), (nodes, cost) = runs
    assert np.max(np.abs(nodes - cpu_nodes)) <= 1e-8 * np.max(np.abs(cpu_nodes))
    assert abs(cost - cpu_cost) <= 1e-8 * cpu_cost
    assert np.median(file_scene.node_errors(nodes, gt_nodes)) < 0.25 * np.median(
        file_scene.node_errors(init, gt_nodes))


def test_view_selection_on_the_card_matches_the_cpu(cuda):
    """`view_selection_mvsnet(recon, 10)` on `tools.file_scene`'s ground
    truth at 64 views and 6,000 tracks, card against CPU: the same
    neighbour lists, scores to 1e-4 relative."""
    from pytheiasfm_tpu_torch.mvs import view_selection_mvsnet
    from pytheiasfm_tpu_torch.tools import file_scene

    _, gt, _ = file_scene.scene(V=64, T=6000)
    cpu = view_selection_mvsnet(gt, 10, device="cpu")
    card = view_selection_mvsnet(gt, 10, device=cuda)
    assert card.keys() == cpu.keys()
    for v, want in cpu.items():
        assert [n for _, n in card[v]] == [n for _, n in want], v
        assert all(abs(a - b) <= 1e-4 * b for (a, _), (b, _) in zip(card[v], want))
