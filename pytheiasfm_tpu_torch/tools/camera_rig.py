"""Bundle adjustment of a rig of several camera models in one problem.

`build_rig` makes one intrinsics group a camera model. Each group has the
views, points and visibility of `utils.synthetic.random_reconstruction`
(a ring of radius 10 around a cube of side 8, seed `seed + group`), at that
model's parameters from the JAX package's camera-model tests
(`tests/test_camera_models.py:15-48`, `MODEL_CASES` and `_params`), which
reach the container through the views' priors. The observations are the
model's own projections of the points plus `noise_px` of Gaussian noise.
No two groups share a track, so each group is its own problem, all of
them solved at once. `perturb` moves every view but the first two of each
group (its gauge) and every point, by numpy draws from one seed. `run_rig`
then runs `bundle_adjust_partial_reconstruction` in f64 with free focal
length and radial distortion, so each group frees its own model's slots
(the iterative Schur with joint intrinsics), and reports the cost, the LM
iterations and each group's median position error against ground truth.
`chip_smoke.py` phase 10 runs it on the CUDA card at its defaults: the
eight models, 64 views and 4,000 tracks a group (512 views, 32,000
tracks).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import default_device
from ..ba.entry import bundle_adjust_partial_reconstruction
from ..ba.lm import BundleAdjustmentOptions
from ..models import intrinsics as intr
from ..models.intrinsics import CameraIntrinsicsModelType as M
from ..models.intrinsics import OptimizeIntrinsicsType
from ..ops import rotation as rotops
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from ..utils.synthetic import SyntheticSceneOptions, random_reconstruction

__all__ = ["MODEL_PARAMS", "RIG_DTYPE", "RIG_OPTIONS", "Rig", "build_rig",
           "perturb", "group_position_errors", "run_rig"]

# Each model's (focal length, aspect ratio, principal point, radial and
# tangential distortion), as the JAX camera-model tests set them.
MODEL_PARAMS = {
    M.PINHOLE: (800.0, 1.05, (640.0, 480.0), (0.01, 0.001), ()),
    M.PINHOLE_RADIAL_TANGENTIAL: (800.0, 1.05, (640.0, 480.0), (0.01, 0.001, 0.0001),
                                  (0.001, 0.0005)),
    M.FISHEYE: (800.0, 1.05, (640.0, 480.0), (0.01, 0.001, 0.0005, 0.0001), ()),
    M.FOV: (800.0, 1.0, (640.0, 480.0), (0.75,), ()),
    M.DIVISION_UNDISTORTION: (1000.0, 1.0, (500.0, 400.0), (-1e-8,), ()),
    M.DOUBLE_SPHERE: (800.0, 1.05, (640.0, 480.0), (0.2, 0.4), ()),
    M.EXTENDED_UNIFIED: (800.0, 1.05, (640.0, 480.0), (0.5, 1.2), ()),
    M.ORTHOGRAPHIC: (30000.0, 1.05, (960.0, 600.0), (0.001, 0.0001), ()),
}

# The rig is solved in f64. In f32 the LM stop falls on rounding noise in
# both packages (the JAX kernels decide on f32 costs; ROADMAP.md section 3),
# and with free focal lengths the groups' positions move along a flat
# valley of the cost: on seven of the models at full size the JAX package
# took 24 LM iterations and the port 9, their final costs 7e-5 apart and
# the groups' median position errors up to 13% apart; and the JAX
# package's f32 BA of the ORTHOGRAPHIC group alone stopped after 3 LM
# iterations at a cost of 4.5e10, short of its noise floor (about 6e4). In
# f64 both packages take the same iterations to the same state, and
# ORTHOGRAPHIC converges (7 iterations, cost 59,899).
RIG_DTYPE = np.float64

RIG_OPTIONS = BundleAdjustmentOptions(
    intrinsics_to_optimize=OptimizeIntrinsicsType.FOCAL_LENGTH
    | OptimizeIntrinsicsType.RADIAL_DISTORTION)

EXTRINSICS_PERTURBATION = 0.005
POINT_PERTURBATION = 0.01


@dataclasses.dataclass
class Rig:
    recon: Reconstruction
    models: tuple
    groups: list  # view ids of each group
    gt_extrinsics: np.ndarray  # [V, 6]
    gt_points: np.ndarray  # [T, 4]


def _prior(model):
    f, aspect, pp, radial, tangential = MODEL_PARAMS[model]
    opt = SyntheticSceneOptions()
    return CameraIntrinsicsPrior(
        image_width=opt.image_width, image_height=opt.image_height,
        camera_intrinsics_model_type=model, focal_length=f, aspect_ratio=aspect, skew=0.0,
        principal_point=pp, radial_distortion=radial, tangential_distortion=tangential)


def build_rig(models=tuple(M), views_per_group=64, tracks_per_group=4000, noise_px=0.5,
              seed=0) -> Rig:
    """One intrinsics group a model, each with `views_per_group` views and
    `tracks_per_group` tracks (module docstring). Group `i` takes the views,
    points and visibility of `random_reconstruction(seed=seed + i)`; its
    noise is drawn from `default_rng([seed, i])`."""
    recon = Reconstruction()
    groups, gt_ext, gt_pts, rows = [], [], [], []
    for gi, model in enumerate(models):
        part = random_reconstruction(num_views=views_per_group, num_tracks=tracks_per_group,
                                     seed=seed + gi)
        v0, t0 = recon.num_views(), recon.num_tracks()
        for v in range(views_per_group):
            recon.add_view(f"{model.name.lower()}_{v:04d}",
                           group_id=None if v == 0 else int(recon.view_group[v0]),
                           prior=_prior(model))
        views = np.arange(v0, v0 + views_per_group)
        recon.view_extrinsics[views] = part.view_extrinsics
        recon.view_estimated[views] = True
        groups.append(views)
        ov, ot = part.obs_view, part.obs_track
        e6 = torch.as_tensor(part.view_extrinsics[ov])
        R = rotops.angle_axis_to_rotation_matrix(e6[:, 3:])
        p_cam = (R @ (torch.as_tensor(part.points[ot, :3]) - e6[:, :3])[..., None])[..., 0]
        params = torch.as_tensor(recon.intrinsics[recon.view_group[v0]])
        uv = intr.camera_to_pixel(params, p_cam, model).numpy()
        uv = uv + np.random.default_rng([seed, gi]).normal(size=uv.shape) * noise_px
        tracks = recon.add_tracks_bulk(tracks_per_group)
        recon.points[tracks] = part.points
        recon.track_estimated[tracks] = part.track_estimated
        rows.append((views[ov], t0 + ot, uv))
        gt_ext.append(part.view_extrinsics)
        gt_pts.append(part.points)
    recon.add_observations_bulk(*(np.concatenate(c) for c in zip(*rows)))
    return Rig(recon, tuple(models), groups, np.concatenate(gt_ext), np.concatenate(gt_pts))


def perturb(rig: Rig, seed=0) -> list[int]:
    """Move every view but each group's first two, and every point, by
    Gaussian draws (0.005 on the extrinsics, 0.01 on the points). Returns
    the views that bundle adjustment may move."""
    recon = rig.recon
    rng = np.random.default_rng(seed)
    free = [int(v) for views in rig.groups for v in views[2:]]
    recon.view_extrinsics[free] += rng.normal(size=(len(free), 6)) * EXTRINSICS_PERTURBATION
    recon.points[:, :3] += rng.normal(size=(recon.num_tracks(), 3)) * POINT_PERTURBATION
    return free


def group_position_errors(rig: Rig, extrinsics: np.ndarray) -> list[float]:
    """Each group's median distance of its camera positions from the ground
    truth (the gauge views fix the frame; no alignment)."""
    err = np.linalg.norm(np.asarray(extrinsics)[:, :3] - rig.gt_extrinsics[:, :3], axis=-1)
    return [float(np.median(err[views])) for views in rig.groups]


def run_rig(device=None, dtype=RIG_DTYPE, options=RIG_OPTIONS, seed=0, **rig_kw):
    """Build, perturb and bundle-adjust the rig on `device` (None: the card).
    Returns a dict: the summary, the seconds of the solve (host clock ending
    in a synchronize), the groups' median position errors, the rig."""
    device = default_device(device)
    rig = build_rig(seed=seed, **rig_kw)
    free = perturb(rig, seed)
    tracks = [int(t) for t in np.nonzero(rig.recon.track_estimated)[0]]
    t0 = time.perf_counter()
    summary = bundle_adjust_partial_reconstruction(options, free, tracks, rig.recon,
                                                   dtype=dtype, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return dict(summary=summary, seconds=seconds,
                median_position_errors=group_position_errors(rig, rig.recon.view_extrinsics),
                rig=rig)
