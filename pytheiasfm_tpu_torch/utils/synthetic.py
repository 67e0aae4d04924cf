"""Seeded synthetic scene generator for tests and benchmarks.

Counterpart of the JAX package's `utils/synthetic.py` (the reference's test
fixture `RandomReconGenerator`, `pytests/sfm/random_recon_gen.py:27`):
ground truth, then calibrated noise. Given one seed both packages build the
same scene: the same numpy draws in the same order, the rotation math in
f64 on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.intrinsics import CameraIntrinsicsModelType
from ..ops import rotation as rotops
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from ..sfm.view_graph import TwoViewInfo, ViewGraph

__all__ = [
    "SyntheticSceneOptions",
    "generate_scene",
    "add_view_graph_edges",
    "random_reconstruction",
]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@dataclasses.dataclass
class SyntheticSceneOptions:
    num_views: int = 10
    num_tracks: int = 200
    camera_radius: float = 10.0
    point_extent: float = 4.0
    focal_length: float = 800.0
    image_width: int = 1024
    image_height: int = 768
    pixel_noise: float = 0.0
    model: CameraIntrinsicsModelType = CameraIntrinsicsModelType.PINHOLE
    seed: int = 42


def _look_at_extrinsics(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - position
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])  # world -> camera
    aa = rotops.rotation_matrix_to_angle_axis(_t(R)).numpy()
    return np.concatenate([position, aa])


def generate_scene(options: SyntheticSceneOptions | None = None):
    """Returns (reconstruction_with_GT_poses, gt_extrinsics [V,6],
    gt_points [T,3]). All views estimated=False, tracks unestimated; the
    observation table holds noiseless-or-noised projections of the GT."""
    opt = options or SyntheticSceneOptions()
    rng = np.random.default_rng(opt.seed)
    V, T = opt.num_views, opt.num_tracks

    angles = np.linspace(0, 2 * np.pi, V, endpoint=False)
    positions = np.stack(
        [
            opt.camera_radius * np.cos(angles),
            opt.camera_radius * np.sin(angles),
            rng.uniform(-1.0, 1.0, V),
        ],
        -1,
    )
    ext = np.stack(
        [_look_at_extrinsics(positions[v], np.zeros(3)) for v in range(V)]
    )
    points = rng.uniform(-opt.point_extent, opt.point_extent, size=(T, 3))

    recon = Reconstruction()
    prior = CameraIntrinsicsPrior(
        image_width=opt.image_width,
        image_height=opt.image_height,
        camera_intrinsics_model_type=opt.model,
        focal_length=opt.focal_length,
        principal_point=(opt.image_width / 2.0, opt.image_height / 2.0),
    )
    for v in range(V):
        # Fresh prior per view so per-view field REASSIGNMENT (position/
        # orientation/gravity priors) is isolated. dataclasses.replace is a
        # shallow copy: ndarray fields on a caller-supplied prior would
        # still alias — only set immutable fields here.
        recon.add_view(
            f"view_{v:04d}", group_id=None, prior=dataclasses.replace(prior)
        )
        recon.view_extrinsics[v] = ext[v]
    recon.set_camera_intrinsics_from_priors()
    recon.add_tracks_bulk(T)

    # Project all points into all views (pinhole fast path in numpy); the
    # rows view by view, as the JAX package adds them one at a time, added
    # in one bulk call.
    fx = opt.focal_length
    cx, cy = opt.image_width / 2.0, opt.image_height / 2.0
    rows = []
    for v in range(V):
        R = rotops.angle_axis_to_rotation_matrix(_t(ext[v, 3:])).numpy()
        p_cam = (points - ext[v, :3]) @ R.T
        z = p_cam[:, 2]
        uv = fx * p_cam[:, :2] / z[:, None] + np.array([cx, cy])
        visible = (
            (z > 0.1)
            & (uv[:, 0] >= 0)
            & (uv[:, 0] < opt.image_width)
            & (uv[:, 1] >= 0)
            & (uv[:, 1] < opt.image_height)
        )
        noise = rng.normal(size=uv.shape) * opt.pixel_noise
        t = np.flatnonzero(visible)
        rows.append((np.full(len(t), v), t, uv[t] + noise[t]))
    recon.add_observations_bulk(*(np.concatenate(c) for c in zip(*rows)))

    return recon, ext, points


def random_reconstruction(
    num_views: int = 6,
    num_tracks: int = 40,
    seed: int = 0,
    pixel_noise: float = 0.0,
    **kwargs,
) -> Reconstruction:
    """A fully-estimated random reconstruction: GT poses + GT points with
    all views/tracks marked estimated, ready for BA/covariance tests — the
    direct analogue of the reference's `RandomReconGenerator.generate_random_recon`
    (`pytests/sfm/random_recon_gen.py:27`). At the GT optimum when
    pixel_noise=0; with pixel_noise>0 the observations are perturbed while
    poses/points stay at GT, so it is only a near-optimum initialization."""
    opt = SyntheticSceneOptions(
        num_views=num_views,
        num_tracks=num_tracks,
        seed=seed,
        pixel_noise=pixel_noise,
        **kwargs,
    )
    recon, ext, points = generate_scene(opt)
    recon.view_estimated[:] = True
    recon.points[:, :3] = points
    recon.points[:, 3] = 1.0
    # Only tracks with >= 2 observations participate in BA.
    recon.track_estimated[:] = np.bincount(recon.obs_track, minlength=recon.num_tracks()) >= 2
    return recon


def add_view_graph_edges(
    recon,
    gt_extrinsics: np.ndarray,
    min_shared_tracks: int = 10,
    rotation_noise_degrees: float = 0.0,
    position_noise_degrees: float = 0.0,
    seed: int = 0,
) -> ViewGraph:
    """Build a ViewGraph whose edges carry (optionally noised) GT relative
    poses for every view pair sharing enough tracks — the synthetic stand-in
    for two-view geometric verification."""
    rng = np.random.default_rng(seed)
    vg = ViewGraph()
    V = recon.num_views()
    for i in range(V):
        for j in range(i + 1, V):
            shared = set(recon.tracks_in_view(i)) & set(recon.tracks_in_view(j))
            if len(shared) < min_shared_tracks:
                continue
            Ri = rotops.angle_axis_to_rotation_matrix(_t(gt_extrinsics[i, 3:])).numpy()
            Rj = rotops.angle_axis_to_rotation_matrix(_t(gt_extrinsics[j, 3:])).numpy()
            R_rel = Rj @ Ri.T
            if rotation_noise_degrees > 0:
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                ang = np.deg2rad(rng.normal() * rotation_noise_degrees)
                R_noise = rotops.angle_axis_to_rotation_matrix(_t(axis * ang)).numpy()
                R_rel = R_noise @ R_rel
            # Relative position of camera j in camera i's frame.
            t_rel = Ri @ (gt_extrinsics[j, :3] - gt_extrinsics[i, :3])
            norm = np.linalg.norm(t_rel)
            if norm > 1e-12:
                t_rel = t_rel / norm
            if position_noise_degrees > 0:
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                ang = np.deg2rad(rng.normal() * position_noise_degrees)
                R_noise = rotops.angle_axis_to_rotation_matrix(_t(axis * ang)).numpy()
                t_rel = R_noise @ t_rel
            info = TwoViewInfo(
                focal_length_1=float(recon.intrinsics[recon.view_group[i]][0]),
                focal_length_2=float(recon.intrinsics[recon.view_group[j]][0]),
                rotation_2=rotops.rotation_matrix_to_angle_axis(_t(R_rel)).numpy(),
                position_2=t_rel,
                num_verified_matches=len(shared),
            )
            vg.add_edge(i, j, info)
    return vg
