"""The port's six estimators of the remaining minimal solvers (P4Pf, P4Pfr,
gDLS and UPnP on a generalized camera, the dominant plane, the
radial-distortion homography) on the scenes of
`tests/test_robust_estimators_extra.py`, at that file's bars.

The port draws from a `torch.Generator`, the JAX package from `jax.random`,
so the estimators are held statistically: each runs on the JAX test's scene
construction (which the JAX package passes at these bars), four problems in
one batched call, the last of them shorter and padded by `mask` with junk
rows (P4Pfr: those four, four times over, held by the share that meets the
bars). The minimal solvers themselves are held to the JAX package value for
value in `test_torch_focal_radial.py`, `test_torch_radial_homography.py`
and `test_torch_generalized_pose.py`.
"""

import numpy as np
import pytest
import torch

from pytheiasfm_tpu_torch.ransac import engine as teng
from pytheiasfm_tpu_torch.ransac import estimators as test_
from test_robust_estimators_extra import _pose_scene
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

PAD = 8  # junk rows of the last problem, masked out


def _params(thresh, iters=256):
    return teng.RansacParameters(error_thresh=thresh, max_iterations=iters,
                                 min_iterations=iters)


def _rotation(rng, scale=0.5):
    aa = rng.normal(size=3) * scale
    th = np.linalg.norm(aa)
    K = np.array([[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _angle_deg(R1, R2):
    return np.degrees(np.arccos(np.clip((np.trace(R1 @ R2.T) - 1) / 2, -1, 1)))


def rig_scene(rng, N=48, n_out=8, scale=None):
    """The JAX test's generalized camera: rays from origins scattered about
    the rig's centre to world points mapped by (s) R X + t, the first n_out
    rays replaced by random directions. Returns (origins, dirs, X, R, t, s)."""
    R_gt = _rotation(rng, 0.4)
    t_gt = rng.normal(size=3)
    s_gt = 1.0 if scale is None else scale
    X = rng.uniform(-3, 3, size=(N, 3))
    Xr = s_gt * (R_gt @ X.T).T + t_gt
    origins = rng.normal(size=(N, 3)) * 0.3
    dirs = Xr - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:n_out] = rng.normal(size=(n_out, 3))
    dirs[:n_out] /= np.linalg.norm(dirs[:n_out], axis=-1, keepdims=True)
    return origins, dirs, X, R_gt, t_gt, s_gt


def plane_scene(rng, N=100, n_out=25):
    """The JAX test's plane: N points with 0.01 noise, the first n_out
    lifted 1-4 units off it. Returns (points, unit normal)."""
    n = np.array([0.2, -0.3, 0.93])
    n /= np.linalg.norm(n)
    basis = np.linalg.svd(n[None])[2][1:]
    pts = np.array([1.0, 2.0, 3.0]) + rng.uniform(-5, 5, size=(N, 2)) @ basis
    pts += rng.normal(size=(N, 3)) * 0.01
    pts[:n_out] += n * rng.uniform(1, 4, size=(n_out, 1))
    return pts, n


def radial_homography_scene(rng, N=64, n_out=10, l1=-0.2, l2=-0.4):
    """The JAX test's plane-induced homography between two views with
    division-model distortion l1, l2; the first n_out right points moved
    0.2-0.5 off. Returns (x1, x2)."""
    H_gt = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    x1 = rng.uniform(-0.6, 0.6, size=(N, 2))
    r2 = np.sum(x1**2, axis=-1, keepdims=True)
    u2 = (H_gt @ np.concatenate([x1, 1.0 + l1 * r2], axis=-1).T).T
    xy, w = u2[:, :2], u2[:, 2:3]
    a = np.sum(xy**2, axis=-1, keepdims=True) * l2
    s = (w + np.sqrt(np.maximum(w**2 - 4 * a, 1e-12))) / 2.0
    x2 = xy / s
    x2[:n_out] += rng.uniform(0.2, 0.5, size=(n_out, 2)) * rng.choice([-1, 1], size=(n_out, 2))
    return x1, x2


def batch(problems):
    """Stack problems of row arrays [n_p, ...], each padded to the longest
    by junk rows that the mask leaves out. Returns ([arrays], mask)."""
    rows = [p[0].shape[0] for p in problems]
    N = max(rows)
    rng = np.random.default_rng(99)
    cols = [torch.tensor(np.stack([
        np.concatenate([p[j], rng.uniform(-50, 50, size=(N - n,) + p[j].shape[1:])])
        for p, n in zip(problems, rows)])) for j in range(len(problems[0]))]
    return cols, torch.arange(N) < torch.tensor(rows)[:, None]


def _check_mask(summary, mask):
    assert not bool(torch.any(summary.inliers & ~mask))


def test_uncalibrated_absolute_pose_batched():
    rng = np.random.default_rng(42)
    scenes = [_pose_scene(rng, N=64 - (PAD if i == 3 else 0), focal=900.0) for i in range(4)]
    (uv, X), mask = batch([s[:2] for s in scenes])
    gen = torch.Generator().manual_seed(0)
    model, summary = test_.estimate_uncalibrated_absolute_pose(
        gen, uv, X, _params(4.0**2), mask=mask)
    _check_mask(summary, mask)
    for p, (_, _, R, c) in enumerate(scenes):
        n = 64 - (PAD if p == 3 else 0)
        assert int(summary.num_inliers[p]) >= n - 12 - 4
        assert float(model.focal_length[p]) == pytest.approx(900.0, rel=0.05)
        np.testing.assert_allclose(model.position[p].numpy(), c, atol=0.1)
        assert _angle_deg(model.rotation[p].numpy(), R) < 3.0


# P4Pfr on the JAX test's scene meets that test's bars (inliers, focal
# length) for some draws only: over the 4 scenes below and
# `jax.random.PRNGKey(0..7)`, in 23 of 32 runs (JAX_P4PFR_SHARE, printed by
# `python tests/torch_minimal_solvers_reference.py p4pfr-share`). Its
# pixels follow the division model only to first order (`_pose_scene`), so
# the minimal fits spread. The port runs each scene 4 times in one call (16
# problems, the last padded) and is held to that share less 0.2.
JAX_P4PFR_SHARE = 23 / 32
P4PFR_SHARE_SLACK = 0.2


def p4pfr_scenes():
    rng = np.random.default_rng(42)
    return [_pose_scene(rng, N=64 - (PAD if i == 3 else 0), focal=1000.0, k1=-2e-8, n_out=8)
            for i in range(4)]


def test_radial_dist_uncalibrated_absolute_pose_batched():
    scenes = p4pfr_scenes()
    order = [0, 1, 2, 3] * 4
    (uv, X), mask = batch([scenes[i][:2] for i in order])
    model, summary = test_.estimate_radial_dist_uncalibrated_absolute_pose(
        torch.Generator().manual_seed(1), uv, X, _params(4.0**2),
        min_focal_length=500.0, max_focal_length=2000.0, mask=mask)
    _check_mask(summary, mask)
    met = [int(summary.num_inliers[p]) >= 64 - (PAD if order[p] == 3 else 0) - 8 - 8
           and abs(float(model.focal_length[p]) - 1000.0) <= 0.1 * 1000.0
           for p in range(16)]
    assert np.mean(met) >= JAX_P4PFR_SHARE - P4PFR_SHARE_SLACK, met


@pytest.mark.parametrize("kind", ["similarity", "rigid"])
def test_rig_transformation_2d_3d_batched(kind):
    rng = np.random.default_rng(42)
    scale = 1.7 if kind == "similarity" else None
    scenes = [rig_scene(rng, N=48 - (PAD if i == 3 else 0), scale=scale) for i in range(4)]
    (o, d, X), mask = batch([s[:3] for s in scenes])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    fn = (test_.estimate_similarity_transformation_2d_3d if kind == "similarity"
          else test_.estimate_rigid_transformation_2d_3d)
    model, summary = fn(torch.Generator().manual_seed(2), o, d, X,
                        _params(np.sin(np.radians(0.5)) ** 2, iters=192), mask=mask)
    _check_mask(summary, mask)
    for p, (_, _, _, R, t, s) in enumerate(scenes):
        n = 48 - (PAD if p == 3 else 0)
        assert int(summary.num_inliers[p]) >= n - 8 - 6
        np.testing.assert_allclose(model.translation[p].numpy(), t, atol=0.05)
        if kind == "similarity":
            assert float(model.scale[p]) == pytest.approx(s, rel=0.02)
        else:
            assert _angle_deg(model.rotation[p].numpy(), R) < 1.0


def test_dominant_plane_batched():
    rng = np.random.default_rng(42)
    scenes = [plane_scene(rng, N=100 - (PAD if i == 3 else 0)) for i in range(4)]
    (pts,), mask = batch([(s[0],) for s in scenes])
    model, summary = test_.estimate_dominant_plane_from_points(
        torch.Generator().manual_seed(4), pts, _params(0.05**2), mask=mask)
    _check_mask(summary, mask)
    for p, (_, n) in enumerate(scenes):
        assert int(summary.num_inliers[p]) >= 70 - (PAD if p == 3 else 0)
        assert abs(float(model.unit_normal[p].numpy() @ n)) > 0.999


# The JAX test draws 384 samples at 15% outliers (a clean 6-sample one
# draw in 2.8); 128 keep about 46 clean samples a problem at a third of
# the CPU time (881 9x9 eigen-solves a sample).
RADIAL_H_ITERS = 128


def test_radial_distortion_homography_batched():
    rng = np.random.default_rng(42)
    scenes = [radial_homography_scene(rng, N=64 - (PAD if i == 3 else 0)) for i in range(4)]
    (x1, x2), mask = batch(scenes)
    model, summary = test_.estimate_radial_distortion_homography(
        torch.Generator().manual_seed(5), x1, x2, _params(0.01**2, iters=RADIAL_H_ITERS),
        mask=mask)
    _check_mask(summary, mask)
    for p in range(4):
        assert int(summary.num_inliers[p]) >= 64 - (PAD if p == 3 else 0) - 10 - 10
        assert float(model.l1[p]) == pytest.approx(-0.2, abs=0.1)
