"""The benchmark's yardstick on the CPU: the reference's projection and
cost against cases worked by hand and against the generator's, its
Gauss-Newton steps, and the BAL-size histogram and generator."""

from __future__ import annotations

import math

import numpy as np
import torch

from sfmbench.reference import ba_refine
from sfmbench.reference import geometry as ref
from sfmbench.scenes import bal

T64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=T64)


def test_projection_worked_by_hand():
    # Camera at the origin, no rotation: x = (0.1, 0.2), r^2 = 0.05,
    # 1 + 0.1 * 0.05 + 0.01 * 0.05^2 = 1.005025.
    intr = t([100.0, 1.0, 0.0, 5.0, 6.0, 0.1, 0.01, 0, 0, 0])
    px = ref.project(t([0, 0, 0, 0, 0, 0]), intr, t([1.0, 2.0, 10.0]))
    assert torch.allclose(px, t([100 * 0.1 * 1.005025 + 5, 100 * 0.2 * 1.005025 + 6]),
                          rtol=0, atol=1e-12)
    # A quarter turn about z maps world (1, 0, 5) - c, c = (0, 0, -5), to
    # camera (0, 1, 10); aspect 2 and skew 3 enter the pixel as Theia's.
    intr = t([50.0, 2.0, 3.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0])
    px = ref.project(t([0, 0, -5, 0, 0, math.pi / 2]), intr, t([1.0, 0.0, 5.0]))
    assert torch.allclose(px, t([50 * 0.0 + 3 * 0.1, 50 * 2 * 0.1]), rtol=0, atol=1e-12)


def test_generator_projection_is_the_references():
    rng = np.random.default_rng(3)
    ext = np.concatenate([rng.normal(size=(50, 3)), rng.normal(size=(50, 3)) * 0.7], 1)
    intr = np.zeros((50, 10))
    intr[:, 0], intr[:, 1], intr[:, 2] = 900 + rng.random(50), 1.0, 0.5
    intr[:, 3:5] = rng.normal(size=(50, 2))
    intr[:, 5:7] = rng.normal(size=(50, 2)) * 0.05
    R = bal.rodrigues(ext[:, 3:])
    X = ext[:, :3] + np.einsum("nji,nj->ni", R, rng.normal(size=(50, 3)) * 0.3 + [0, 0, 4])
    assert np.allclose(bal.project(ext, intr, X),
                       ref.project(t(ext), t(intr), t(X)).numpy(), rtol=0, atol=1e-9)


def test_cost_is_half_the_squared_residuals():
    assert ref.cost(t([[3.0, 4.0], [1.0, 0.0]])) == 13.0


def test_gauss_newton_lands_on_the_minimum():
    s = bal.build(12, 300, 1500, 2, 8, 4, 0.5, (800, 1600), (-0.1, 0.1), (-0.02, 0.02),
                  0.02, 0.2, 0.02, 0.01, 0.002, 0.01, problem_seed=4, seed=4)
    ov = torch.as_tensor(s["obs_view"], dtype=torch.int64)
    ot = torch.as_tensor(s["obs_track"], dtype=torch.int64)
    obs = (ov, ov, ot, t(s["obs_uv"]))
    gt = ref.cost(ref.residuals(t(np.concatenate([s["positions"], s["aa"]], 1)),
                                t(s["intrinsics"]), t(s["points"]), *obs))
    start, best = ba_refine.refine(t(s["start_ext"]), t(s["start_intr"]),
                                   t(s["start_points"]), obs, [0, 5, 6], steps=6)
    assert start > 10 * gt and best < gt
    # From the minimum two more steps move the cost by rounding alone.
    ext, intr, X = t(s["start_ext"]), t(s["start_intr"]), t(s["start_points"])
    for _ in range(8):
        ext, intr, X = ba_refine.gauss_newton_step(ext, intr, X, obs, [0, 5, 6], 1e-9)
    again, better = ba_refine.refine(ext, intr, X, obs, [0, 5, 6])
    assert abs(again - better) <= 1e-10 * again


def test_bal_histogram_has_dubrovniks_sums():
    lengths, counts = bal.length_histogram(226_730, 1_255_268, 2, 16)
    assert counts.sum() == 226_730 and int(counts @ lengths) == 1_255_268
    assert counts.min() > 0 and lengths.max() == 16


def test_bal_generator_poses_one_problem_for_every_seed():
    kw = dict(views=20, tracks=400, observations=2200, min_length=2, max_length=9,
              neighborhood=5, noise_px=0.5, focal_range=(800, 1600), k1_range=(-0.1, 0.1),
              k2_range=(-0.02, 0.02), start_position_sigma=0.02, start_rotation_sigma_deg=0.2,
              start_focal_sigma=0.02, start_k1_sigma=0.01, start_k2_sigma=0.002,
              start_point_sigma=0.01, problem_seed=3)
    a, b = bal.build(**kw, seed=1), bal.build(**kw, seed=2**31 + 5)
    assert len(a["obs_view"]) == len(b["obs_view"]) == 2200
    assert np.array_equal(np.bincount(np.bincount(a["obs_track"])),
                          np.bincount(np.bincount(b["obs_track"])))
    for s in (a, b):  # every track's views distinct
        key = s["obs_track"].astype(np.int64) * 20 + s["obs_view"]
        assert len(np.unique(key)) == len(key)
    # The same problem in another order of its tracks: each track keeps its
    # observations and its points, under another label.
    assert not np.array_equal(a["obs_track"], b["obs_track"])
    for k in ("positions", "aa", "intrinsics", "start_ext", "start_intr"):
        assert np.array_equal(a[k], b[k]), k

    def tracks(s):
        return sorted((tuple(s["points"][t]), tuple(s["start_points"][t]),
                       tuple(map(tuple, s["obs_uv"][s["obs_track"] == t])),
                       tuple(s["obs_view"][s["obs_track"] == t])) for t in range(400))
    assert tracks(a) == tracks(b)
    for s in (a, b):  # grouped by track
        assert np.all(np.diff(s["obs_track"]) >= 0)
