"""Native checkpoint: versioned npz of the SoA scene state (+ JSON export).

Counterpart of the JAX package's `io/recon.py`
(`theia/io/reconstruction_writer.cc:38,72`, `reconstruction_reader.cc:38,71`).
The npz keys and `format_version` are the JAX package's, so each package
reads the other's checkpoints. The reader appends the tracks and
observations in bulk (the JAX reader adds them a row at a time).
"""

from __future__ import annotations

import json

import numpy as np

from ..models.intrinsics import CameraIntrinsicsModelType
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction

__all__ = ["write_reconstruction", "read_reconstruction", "write_reconstruction_json"]

_FORMAT_VERSION = 1


def write_reconstruction(recon: Reconstruction, path: str) -> None:
    """Parity: `theia::WriteReconstruction` (`reconstruction_writer.cc:38`)."""
    priors = [
        {
            "image_width": p.image_width,
            "image_height": p.image_height,
            "model": int(p.camera_intrinsics_model_type),
            "focal_length": p.focal_length,
            "principal_point": list(p.principal_point) if p.principal_point else None,
            "aspect_ratio": p.aspect_ratio,
            "skew": p.skew,
            "radial_distortion": list(p.radial_distortion),
            "tangential_distortion": list(p.tangential_distortion),
        }
        for p in recon.view_priors
    ]
    np.savez_compressed(
        path,
        format_version=np.int32(_FORMAT_VERSION),
        view_names=np.asarray(recon.view_names, dtype=object),
        view_timestamps=np.asarray(recon.view_timestamps),
        view_extrinsics=recon.view_extrinsics,
        view_group=recon.view_group,
        view_estimated=recon.view_estimated,
        view_priors_json=np.asarray(json.dumps(priors)),
        intrinsics=recon.intrinsics,
        group_model=np.asarray([int(m) for m in recon.group_model], np.int32),
        points=recon.points,
        track_estimated=recon.track_estimated,
        track_colors=recon.track_colors,
        track_inverse_depth=recon.track_inverse_depth,
        track_reference_view=recon.track_reference_view,
        obs_view=recon.obs_view,
        obs_track=recon.obs_track,
        obs_uv=recon.obs_uv,
        obs_sqrt_inv_cov=recon.obs_sqrt_inv_cov,
        obs_depth_prior=recon.obs_depth_prior,
        obs_depth_prior_variance=recon.obs_depth_prior_variance,
    )


def read_reconstruction(path: str) -> Reconstruction:
    """Parity: `theia::ReadReconstruction` (`reconstruction_reader.cc:38`)."""
    data = np.load(path, allow_pickle=True)
    version = int(data["format_version"])
    if version > _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} is newer than supported")

    recon = Reconstruction()
    priors = json.loads(str(data["view_priors_json"]))
    groups = data["view_group"]
    for i, name in enumerate(data["view_names"]):
        p = priors[i]
        prior = CameraIntrinsicsPrior(
            image_width=p["image_width"],
            image_height=p["image_height"],
            camera_intrinsics_model_type=CameraIntrinsicsModelType(p["model"]),
            focal_length=p["focal_length"],
            principal_point=tuple(p["principal_point"]) if p["principal_point"] else None,
            aspect_ratio=p["aspect_ratio"],
            skew=p["skew"],
            radial_distortion=tuple(p["radial_distortion"]),
            tangential_distortion=tuple(p["tangential_distortion"]),
        )
        recon.add_view(str(name), group_id=int(groups[i]),
                       timestamp=float(data["view_timestamps"][i]), prior=prior)
    # Overwrite the arrays wholesale (add_view built the right shapes).
    recon.view_extrinsics = np.array(data["view_extrinsics"])
    recon.view_group = np.array(data["view_group"])
    recon.view_estimated = np.array(data["view_estimated"])
    recon.intrinsics = np.array(data["intrinsics"])
    recon.group_model = [CameraIntrinsicsModelType(int(m)) for m in data["group_model"]]
    recon.add_tracks_bulk(len(data["points"]))
    recon.points = np.array(data["points"])
    recon.track_estimated = np.array(data["track_estimated"])
    recon.track_colors = np.array(data["track_colors"])
    recon.track_inverse_depth = np.array(data["track_inverse_depth"])
    recon.track_reference_view = np.array(data["track_reference_view"])
    recon.add_observations_bulk(data["obs_view"], data["obs_track"], data["obs_uv"],
                                data["obs_sqrt_inv_cov"])
    recon.obs_depth_prior = np.array(data["obs_depth_prior"])
    recon.obs_depth_prior_variance = np.array(data["obs_depth_prior_variance"])
    return recon


def write_reconstruction_json(recon: Reconstruction, path: str) -> None:
    """Parity: `theia::WriteReconstructionJson` (`reconstruction_writer.h:59`)."""
    out = {
        "views": [
            {
                "name": recon.view_names[v],
                "timestamp": recon.view_timestamps[v],
                "estimated": bool(recon.view_estimated[v]),
                "position": recon.view_extrinsics[v, :3].tolist(),
                "orientation_angle_axis": recon.view_extrinsics[v, 3:].tolist(),
                "intrinsics_group": int(recon.view_group[v]),
            }
            for v in range(recon.num_views())
        ],
        "intrinsics_groups": [
            {"model": int(recon.group_model[g]), "parameters": recon.intrinsics[g].tolist()}
            for g in range(len(recon.group_model))
        ],
        "tracks": [
            {"point": p, "estimated": e, "color": c}
            for p, e, c in zip(recon.points.tolist(), recon.track_estimated.tolist(),
                               recon.track_colors.tolist())
        ],
        "observations": [
            {"view": v, "track": t, "pixel": uv}
            for v, t, uv in zip(recon.obs_view.tolist(), recon.obs_track.tolist(),
                                recon.obs_uv.tolist())
        ],
    }
    with open(path, "w") as f:
        f.write(json.dumps(out))  # json.dump's text, by the C encoder


def append_tracks(recon: Reconstruction, points4, colors, counts, obs_view, obs_uv):
    """Append tracks with their observations in one bulk call: what
    `add_track` (estimated when `points4` [T, 4] is given), the color and
    `add_observation` a row at a time give, the observations listed track
    after track (`counts` [T] of them for each)."""
    ids = recon.add_tracks_bulk(len(counts))
    if points4 is not None:
        recon.points[ids] = points4
        recon.track_estimated[ids] = True
    recon.track_colors[ids] = colors
    recon.add_observations_bulk(np.asarray(obs_view, np.int32).reshape(-1),
                                np.repeat(ids, np.asarray(counts, np.int64)),
                                np.asarray(obs_uv, np.float64).reshape(-1, 2))
    return ids
