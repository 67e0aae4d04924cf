"""Batched absolute pose at localization scale: one P3P RANSAC problem a view.

    python -m pytheiasfm_tpu_torch.tools.localization

`build_problems` turns the synthetic Notre-Dame-scale scene
(`pipelines.synthetic_global.build_scene`: 553 views, 50,000 tracks, seed 0)
into one 2D-3D problem per view: each observation normalized by the view's
focal length and principal point, paired with its track's ground-truth
point, with a share of each view's points (30%) replaced by outliers drawn
uniformly from the scene's box. The threshold is `sfm/localize.py`'s (4 px,
resolution-scaled, over the focal length, squared) and the RANSAC
parameters `set_ransac_parameters(ReconstructionEstimatorOptions())` (LO
on). `run_variant` solves every problem in one batched call
(`estimate_calibrated_absolute_pose`) under one of `VARIANTS`, and `errors`
reads the result against ground truth. Run as a script it times each
variant on the card and prints its errors and peak memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..pipelines import synthetic_global
from ..ransac import estimators
from ..sfm.estimator_options import ReconstructionEstimatorOptions, set_ransac_parameters
from ..sfm.two_view import compute_resolution_scaled_threshold

__all__ = ["VARIANTS", "build_problems", "errors", "run_variant"]

OUTLIER_SHARE = 0.3
REPROJECTION_ERROR_PIXELS = 4.0  # `LocalizeViewToReconstructionOptions`' default
MIN_INLIERS = 30
# name -> (changes to the RANSAC parameters, quality)
VARIANTS = {
    "default (LO)": (dict(), "inlier"),
    "LO + SPRT": (dict(use_Tdd_test=True), "inlier"),
    "PROSAC": (dict(sampler="prosac"), "inlier"),
    "LMed": (dict(), "lmed"),
}


def _scene_points(V: int, T: int, seed: int) -> np.ndarray:
    """The ground-truth points of `build_scene(V, T, seed=seed)`: its draws
    replayed up to them (the ring's angles and heights, then the points)."""
    rng = np.random.default_rng(seed)
    rng.uniform(0, 2 * np.pi, V)
    rng.normal(size=V)
    return rng.uniform(-3, 3, size=(T, 3))


def build_problems(V: int = 553, T: int = 50_000, seed: int = 0,
                   outlier_share: float = OUTLIER_SHARE):
    """Returns a dict of host arrays: `feature` [P, N, 2] normalized,
    `world` [P, N, 3], `mask` [P, N] (each view's rows first, padded to the
    largest view), `thresh` [P] squared normalized thresholds, the ground
    truth `rotation` [P, 3, 3] (world->camera) and `position` [P, 3], and
    the views' `focal_length` in pixels."""
    recon, _, positions = synthetic_global.build_scene(V=V, T=T, seed=seed)
    points = _scene_points(V, T, seed)
    z = -positions / np.linalg.norm(positions, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rotation = np.stack([x, np.cross(z, x), z], axis=1)

    prior = recon.view_priors[0]
    f = prior.focal_length
    pp = np.asarray(prior.principal_point)
    thresh_px = compute_resolution_scaled_threshold(
        REPROJECTION_ERROR_PIXELS, prior.image_width, prior.image_height)
    order = np.argsort(recon.obs_view, kind="stable")
    views = recon.obs_view[order]
    counts = np.bincount(views, minlength=V)
    N = int(counts.max())
    slot = np.arange(len(views)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[views]
    feature = np.zeros((V, N, 2))
    world = np.zeros((V, N, 3))
    mask = np.arange(N) < counts[:, None]
    feature[views, slot] = (recon.obs_uv[order] - pp) / f
    world[views, slot] = points[recon.obs_track[order]]

    # The observations are the points' projections: a check on the replay.
    cam = np.einsum("nij,nj->ni", rotation[views], world[views, slot] - positions[views])
    reproj = np.abs(cam[:, :2] / cam[:, 2:] - feature[views, slot]).max() * f
    if not reproj < 10.0:
        raise RuntimeError(f"scene replay: observations {reproj:.1f} px off their points")

    rng = np.random.default_rng([seed, 12])
    for v in range(V):
        bad = rng.choice(counts[v], size=int(round(outlier_share * counts[v])), replace=False)
        world[v, bad] = rng.uniform(-3, 3, size=(len(bad), 3))
    return dict(feature=feature, world=world, mask=mask,
                thresh=np.full(V, (thresh_px / f) ** 2), rotation=rotation,
                position=positions, focal_length=f)


def parameters(name: str):
    """(RansacParameters, quality) of a variant."""
    changes, quality = VARIANTS[name]
    params = set_ransac_parameters(ReconstructionEstimatorOptions())
    return dataclasses.replace(params, **changes), quality


def run_variant(problems, name: str, generator: torch.Generator, device,
                dtype=torch.float32):
    """All problems in one batched `estimate_calibrated_absolute_pose` call
    under variant `name`. Returns (model, summary)."""
    params, quality = parameters(name)

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    return estimators.estimate_calibrated_absolute_pose(
        generator, t(problems["feature"]), t(problems["world"]), params,
        mask=t(problems["mask"], torch.bool), quality=quality,
        error_thresh=t(problems["thresh"]),
    )


def errors(rotation, position, num_inliers, problems):
    """(median rotation error in degrees, median position error in scene
    units, share of views with at least MIN_INLIERS inliers) of estimated
    rotations [P, 3, 3] and positions [P, 3] (host arrays)."""
    rel = np.einsum("pij,pkj->pik", np.asarray(rotation, np.float64), problems["rotation"])
    # The angle as atan2(sin, cos): arccos of the trace alone would turn an
    # f32 rotation's rounding into about 0.03 deg.
    sin = 0.5 * np.linalg.norm(np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                                         rel[:, 1, 0] - rel[:, 0, 1]], -1), axis=-1)
    cos = 0.5 * (np.trace(rel, axis1=1, axis2=2) - 1)
    rot = np.degrees(np.arctan2(sin, cos))
    pos = np.linalg.norm(np.asarray(position, np.float64) - problems["position"], axis=1)
    return float(np.median(rot)), float(np.median(pos)), float(np.mean(
        np.asarray(num_inliers) >= MIN_INLIERS))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("localization: needs a CUDA card")
    dev = torch.device("cuda")
    problems = build_problems()
    print(f"{problems['mask'].shape[0]} problems of {problems['mask'].sum(1).min()}-"
          f"{problems['mask'].sum(1).max()} rows", flush=True)
    for name in VARIANTS:
        for label in ("first", "warm"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, summary = run_variant(problems, name,
                                         torch.Generator(device=dev).manual_seed(0), dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rot, pos, share = errors(model.rotation.cpu().numpy(), model.position.cpu().numpy(),
                                     summary.num_inliers.cpu().numpy(), problems)
            print(f"[{name}, {label}] {secs:.3f} s; median rotation error {rot!r} deg, median "
                  f"position error {pos!r}, share with >= {MIN_INLIERS} inliers {share!r}; "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
