"""The port's track estimator (`pytheiasfm_tpu_torch/sfm/track_estimator.py`)
against the JAX package's `sfm/track_estimator.py`, on the CPU.

Scene: `utils.synthetic.generate_scene` (8 views, 150 tracks, 0.3 px noise,
seed 7) from the JAX package, converted into the port's container; the
views are posed from ground truth plus noise (5 mm, 0.03 deg), view 5 is
left unestimated, and 20 tracks are marked estimated already (both are
skipped). A 1.5 px gate makes the acceptance set non-trivial.

Bars: the success sets are equal; the accepted points agree to 1e-8 (f64,
MIDPOINT and SVD, the Gauss-Newton refinement on and off) and to 1e-4
relative to their norm (f32, the default dtype: both sides round the same
inputs to f32, then differ in the order of sums).
"""

import copy

import numpy as np
import pytest
import torch

from pytheiasfm_tpu.sfm import track_estimator as jte
from pytheiasfm_tpu.utils.synthetic import SyntheticSceneOptions, generate_scene
from pytheiasfm_tpu_torch import convert
from pytheiasfm_tpu_torch.sfm import track_estimator as tte
from pytheiasfm_tpu_torch.utils import counters

F64_TOL = 1e-8
F32_REL_TOL = 1e-4
GATE_PX = 1.5


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """Run the module's PyTorch on one CPU thread. The port's eager ops on
    small tensors run fastest so, and the tier-1 run shares the CPU among
    several workers, where each worker's thread pool would oversubscribe it
    (measured: the BA and estimator files take 2-20x as long). Shared by the
    other main-path test files, which import it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene():
    recon, gt_ext, _ = generate_scene(
        SyntheticSceneOptions(num_views=8, num_tracks=150, pixel_noise=0.3, seed=7)
    )
    rng = np.random.default_rng(0)
    recon.view_extrinsics[:, :3] = gt_ext[:, :3] + rng.normal(size=(8, 3)) * 0.005
    recon.view_extrinsics[:, 3:] = gt_ext[:, 3:] + rng.normal(size=(8, 3)) * np.deg2rad(0.03)
    recon.view_estimated[:] = True
    recon.view_estimated[5] = False
    recon.track_estimated[::7] = True
    recon.points[::7] = [0.0, 0.0, 0.0, 1.0]
    return recon


def _options(module, method, ba):
    return module.TrackEstimatorOptions(
        max_acceptable_reprojection_error_pixels=GATE_PX,
        triangulation_method=module.TriangulationMethodType(method),
        bundle_adjustment=ba,
    )


def _run_both(method, ba, dtype):
    jrecon = _scene()
    trecon = convert.reconstruction(jrecon)
    js = jte.estimate_all_tracks(jrecon, _options(jte, method, ba), dtype=dtype)
    counters.reset()
    ts = tte.estimate_all_tracks(trecon, _options(tte, method, ba), dtype=dtype, device="cpu")
    assert counters.snapshot() == {"triangulate_launch": 1}
    return jrecon, js, trecon, ts


@pytest.mark.parametrize("ba", [True, False])
@pytest.mark.parametrize("method", [0, 1])  # MIDPOINT, SVD
def test_estimate_tracks_f64(method, ba):
    jrecon, js, trecon, ts = _run_both(method, ba, np.float64)
    assert ts.estimated_tracks == js.estimated_tracks
    assert ts.num_triangulation_attempts == js.num_triangulation_attempts == 128
    assert ts.input_num_estimated_tracks == js.input_num_estimated_tracks == 22
    assert 60 < len(ts.estimated_tracks) < ts.num_triangulation_attempts
    np.testing.assert_array_equal(trecon.track_estimated, jrecon.track_estimated)
    np.testing.assert_allclose(trecon.points, jrecon.points, rtol=0, atol=F64_TOL)


def test_estimate_tracks_f32_defaults():
    jrecon, js, trecon, ts = _run_both(0, True, np.float32)
    assert ts.estimated_tracks == js.estimated_tracks
    ids = sorted(ts.estimated_tracks)
    scale = np.linalg.norm(jrecon.points[ids, :3], axis=-1)
    rel = np.linalg.norm(trecon.points[ids, :3] - jrecon.points[ids, :3], axis=-1) / scale
    assert rel.max() < F32_REL_TOL, rel.max()


def test_estimate_tracks_subset_in_listed_order():
    """A track list in another order, with a repeat and estimated tracks:
    the same tracks are attempted and accepted as in the JAX package."""
    ids = [149, 3, 77, 3, 14, 60, 61, 100]
    jrecon = _scene()
    trecon = convert.reconstruction(jrecon)
    opts = (_options(jte, 0, True), _options(tte, 0, True))
    js = jte.estimate_tracks(jrecon, ids, opts[0], dtype=np.float64)
    ts = tte.estimate_tracks(trecon, ids, opts[1], dtype=np.float64, device="cpu")
    assert ts.estimated_tracks == js.estimated_tracks
    np.testing.assert_allclose(trecon.points, jrecon.points, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("method", [0, 1, 2])
def test_triangulate_tracks_arrays(method):
    """The batched kernel itself on [T, K] arrays with masked slots: equal
    success and points to 1e-8 (f64)."""
    rng = np.random.default_rng(1)
    T, K = 64, 4
    X = rng.uniform(-2, 2, (T, 3))
    c = np.stack([rng.uniform(-1, 1, (T, K)), rng.uniform(-1, 1, (T, K)),
                  np.full((T, K), -8.0)], -1)
    aa = rng.normal(size=(T, K, 3)) * 0.05
    ext = np.concatenate([c, aa], -1)
    from pytheiasfm_tpu_torch.ops.rotation_np import angle_axis_to_rotation_matrix_np

    R = angle_axis_to_rotation_matrix_np(aa.reshape(-1, 3)).reshape(T, K, 3, 3)
    Xc = np.einsum("tkij,tkj->tki", R, X[:, None] - c)
    uv = Xc[..., :2] / Xc[..., 2:] + rng.normal(size=(T, K, 2)) * 5e-4
    mask = np.ones((T, K), bool)
    mask[::4, 2:] = False
    mask[1::8, 1:] = False  # one observation only: never accepted
    focal = np.full((T, K), 800.0)
    import jax.numpy as jnp

    j4, jok = jte.triangulate_tracks(
        *(jnp.asarray(a) for a in (ext, uv, focal, mask)), jnp.asarray(2.0),
        jnp.asarray(3.0), method=method)
    t4, tok = tte.triangulate_tracks(
        *(torch.as_tensor(a) for a in (ext, uv, focal, mask)), 2.0, 3.0, method=method)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < int(tok.sum()) < T
    ok = tok.numpy()
    np.testing.assert_allclose(t4.numpy()[ok], np.asarray(j4)[ok], rtol=0, atol=F64_TOL)


def test_mesh_raises():
    """A device mesh no longer raises: on a 1-rank mesh the triangulation is
    one device's (4 ranks in `test_torch_mesh_sfm.py`)."""
    from torch_mesh_cases import one_rank_mesh

    recon = convert.reconstruction(_scene())
    on_mesh = copy.deepcopy(recon)
    with one_rank_mesh() as mesh:
        s_mesh = tte.estimate_all_tracks(on_mesh, tte.TrackEstimatorOptions(mesh=mesh),
                                         device="cpu")
    s_one = tte.estimate_all_tracks(recon, tte.TrackEstimatorOptions(), device="cpu")
    assert s_mesh.estimated_tracks == s_one.estimated_tracks
    np.testing.assert_array_equal(on_mesh.points, recon.points)
