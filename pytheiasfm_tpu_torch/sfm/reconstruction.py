"""The scene data model: a struct-of-arrays `Reconstruction`.

Counterpart of the JAX package's `sfm/reconstruction.py`
(`theia/sfm/reconstruction.h:66`, `View` `view.h:57`, `Track` `track.h:53`).
The scene is flat host arrays:

    views:        extrinsics [V, 6] ([position, angle-axis], camera.h:202),
                  intrinsics group index [V], estimated mask [V]
    intrinsics:   [G, MAX_INTRINSICS] shared groups (reconstruction.cc:131)
    tracks:       homogeneous points [T, 4], estimated mask [T], color,
                  inverse depth + reference view (track.h:80-113)
    observations: flat table (view idx, track idx, pixel, sqrt-inv covariance)

The class is host-side and mutable, with the reference's container API.
The export to the bundle adjuster's device arrays comes with the BA port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..models import intrinsics as intr
from ..models.intrinsics import MAX_INTRINSICS, CameraIntrinsicsModelType

__all__ = ["CameraIntrinsicsPrior", "Reconstruction", "kInvalidTrackId", "kInvalidViewId"]

kInvalidViewId = -1
kInvalidTrackId = -1


@dataclasses.dataclass
class CameraIntrinsicsPrior:
    """Parity: `theia::CameraIntrinsicsPrior`
    (`sfm/camera_intrinsics_prior.h`) — per-image metadata, each field an
    (is_set, value) prior."""

    image_width: int = 0
    image_height: int = 0
    camera_intrinsics_model_type: CameraIntrinsicsModelType = (
        CameraIntrinsicsModelType.PINHOLE
    )
    focal_length: Optional[float] = None
    principal_point: Optional[tuple[float, float]] = None
    aspect_ratio: Optional[float] = None
    skew: Optional[float] = None
    radial_distortion: tuple[float, ...] = ()
    tangential_distortion: tuple[float, ...] = ()
    position: Optional[np.ndarray] = None
    position_sqrt_information: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None
    orientation_sqrt_information: Optional[np.ndarray] = None
    gravity: Optional[np.ndarray] = None
    gravity_sqrt_information: Optional[np.ndarray] = None
    latitude: Optional[float] = None
    longitude: Optional[float] = None
    altitude: Optional[float] = None

    def to_intrinsics(self, dtype=np.float64) -> np.ndarray:
        """Build the padded intrinsics vector from whatever priors are set
        (parity: `SetFromCameraIntrinsicsPriors` per model)."""
        model = self.camera_intrinsics_model_type
        focal = self.focal_length
        if focal is None:
            # Reference default: 1.2 * max dimension when no prior exists
            # (sfm/set_camera_intrinsics_from_priors.cc).
            focal = 1.2 * max(self.image_width, self.image_height, 1)
        pp = self.principal_point
        if pp is None:
            pp = (self.image_width / 2.0, self.image_height / 2.0)
        params = intr.make_intrinsics_np(
            model,
            focal_length=float(focal),
            aspect_ratio=float(self.aspect_ratio or 1.0),
            skew=float(self.skew or 0.0),
            principal_point=pp,
            distortion=tuple(self.radial_distortion)
            + tuple(self.tangential_distortion),
        )
        return np.asarray(params, dtype)


class Reconstruction:
    """Host-side scene container with the reference's API shape."""

    def __init__(self, dtype=np.float64):
        self.dtype = dtype
        # Views.
        self.view_names: list[str] = []
        self.view_name_to_id: dict[str, int] = {}
        self.view_timestamps: list[float] = []
        self.view_extrinsics = np.zeros((0, 6), dtype)
        self.view_group: np.ndarray = np.zeros((0,), np.int32)
        self.view_estimated = np.zeros((0,), bool)
        self.view_priors: list[CameraIntrinsicsPrior] = []
        # Intrinsics groups.
        self.intrinsics = np.zeros((0, MAX_INTRINSICS), dtype)
        self.group_model: list[CameraIntrinsicsModelType] = []
        # Tracks.
        self.points = np.zeros((0, 4), dtype)
        self.track_estimated = np.zeros((0,), bool)
        self.track_colors = np.zeros((0, 3), np.uint8)
        self.track_inverse_depth = np.zeros((0,), dtype)
        self.track_reference_view = np.zeros((0,), np.int32)
        # Observations: one row per (view, track) feature.
        self.obs_view = np.zeros((0,), np.int32)
        self.obs_track = np.zeros((0,), np.int32)
        self.obs_uv = np.zeros((0, 2), dtype)
        self.obs_sqrt_inv_cov = np.zeros((0, 2), dtype)  # diagonal sqrt info
        self.obs_depth_prior = np.zeros((0,), dtype)
        self.obs_depth_prior_variance = np.zeros((0,), dtype)
        # track -> list of obs row indices; view -> dict track -> obs row.
        self._track_obs: list[list[int]] = []
        self._view_track_to_obs: list[dict[int, int]] = []

    # ------------------------------------------------------------------ views

    def num_views(self) -> int:
        return len(self.view_names)

    def num_tracks(self) -> int:
        return len(self.points)

    def num_observations(self) -> int:
        return len(self.obs_view)

    def add_view(
        self,
        name: str,
        group_id: int | None = None,
        timestamp: float = 0.0,
        prior: CameraIntrinsicsPrior | None = None,
    ) -> int:
        """Parity: `Reconstruction::AddView(name, group, timestamp)`
        (`reconstruction.h:99-112`): a view added into an existing group
        shares that group's intrinsics array row."""
        if name in self.view_name_to_id:
            return kInvalidViewId
        view_id = len(self.view_names)
        prior = prior or CameraIntrinsicsPrior()
        if group_id is None or group_id >= len(self.group_model):
            group_id = len(self.group_model)
            self.group_model.append(prior.camera_intrinsics_model_type)
            self.intrinsics = np.vstack(
                [self.intrinsics, prior.to_intrinsics(self.dtype)[None]]
            )
        self.view_names.append(name)
        self.view_name_to_id[name] = view_id
        self.view_timestamps.append(timestamp)
        self.view_extrinsics = np.vstack([self.view_extrinsics, np.zeros((1, 6), self.dtype)])
        self.view_group = np.append(self.view_group, np.int32(group_id))
        self.view_estimated = np.append(self.view_estimated, False)
        self.view_priors.append(prior)
        self._view_track_to_obs.append({})
        return view_id

    def view_id_from_name(self, name: str) -> int:
        return self.view_name_to_id.get(name, kInvalidViewId)

    # ----------------------------------------------------------------- tracks

    def add_track(self, point4: np.ndarray | None = None) -> int:
        """Parity: `Reconstruction::AddTrack` (`reconstruction.h:115`)."""
        track_id = len(self.points)
        p = np.zeros((4,), self.dtype) if point4 is None else np.asarray(point4, self.dtype)
        self.points = np.vstack([self.points, p[None]])
        self.track_estimated = np.append(self.track_estimated, point4 is not None)
        self.track_colors = np.vstack([self.track_colors, np.zeros((1, 3), np.uint8)])
        self.track_inverse_depth = np.append(self.track_inverse_depth, 0.0)
        self.track_reference_view = np.append(
            self.track_reference_view, np.int32(kInvalidViewId)
        )
        self._track_obs.append([])
        return track_id

    def add_observation(
        self,
        view_id: int,
        track_id: int,
        pixel: np.ndarray,
        sqrt_inv_cov: np.ndarray | None = None,
    ) -> bool:
        """Parity: `Reconstruction::AddObservation` (`reconstruction.h:132`).
        Rejects a second feature of the same track in the same view (the
        track-consistency contract of the reference)."""
        if track_id in self._view_track_to_obs[view_id]:
            return False
        row = len(self.obs_view)
        self.obs_view = np.append(self.obs_view, np.int32(view_id))
        self.obs_track = np.append(self.obs_track, np.int32(track_id))
        self.obs_uv = np.vstack([self.obs_uv, np.asarray(pixel, self.dtype)[None]])
        sic = (
            np.ones((2,), self.dtype)
            if sqrt_inv_cov is None
            else np.asarray(sqrt_inv_cov, self.dtype)
        )
        self.obs_sqrt_inv_cov = np.vstack([self.obs_sqrt_inv_cov, sic[None]])
        self.obs_depth_prior = np.append(self.obs_depth_prior, 0.0)
        self.obs_depth_prior_variance = np.append(self.obs_depth_prior_variance, 0.0)
        self._track_obs[track_id].append(row)
        self._view_track_to_obs[view_id][track_id] = row
        if self.track_reference_view[track_id] == kInvalidViewId:
            self.track_reference_view[track_id] = view_id
        return True

    def add_tracks_bulk(self, count: int) -> np.ndarray:
        """Vectorized `AddTrack` x count: returns the new track ids."""
        base = self.num_tracks()
        ids = np.arange(base, base + count)
        self.points = np.vstack([self.points, np.zeros((count, 4), self.dtype)])
        self.track_estimated = np.concatenate(
            [self.track_estimated, np.zeros(count, bool)]
        )
        self.track_colors = np.vstack(
            [self.track_colors, np.zeros((count, 3), np.uint8)]
        )
        self.track_inverse_depth = np.concatenate(
            [self.track_inverse_depth, np.zeros(count, self.dtype)]
        )
        self.track_reference_view = np.concatenate(
            [self.track_reference_view, np.full(count, kInvalidViewId, np.int32)]
        )
        self._track_obs.extend([] for _ in range(count))
        return ids

    def add_observations_bulk(
        self,
        view_ids,
        track_ids,
        pixels,
        sqrt_inv_cov=None,
    ) -> int:
        """Vectorized `AddObservation` for large scenes.

        One array concatenation instead of per-row vstack (which is
        quadratic in the observation count). Duplicate (view, track) rows —
        within the batch or against existing observations — are dropped,
        keeping the first, preserving the track-consistency contract of
        `Reconstruction::AddObservation` (`reconstruction.h:132`).
        Returns the number of observations actually added.
        """
        view_ids = np.asarray(view_ids, np.int32)
        track_ids = np.asarray(track_ids, np.int32)
        pixels = np.asarray(pixels, self.dtype).reshape(len(view_ids), 2)
        nt = max(self.num_tracks(), 1)
        key = view_ids.astype(np.int64) * nt + track_ids
        _, first = np.unique(key, return_index=True)
        keep = np.zeros(len(key), bool)
        keep[first] = True
        if len(self.obs_view):
            existing = {
                (int(v), int(t))
                for v, d in enumerate(self._view_track_to_obs)
                for t in d
            }
            for i in np.nonzero(keep)[0]:
                if (int(view_ids[i]), int(track_ids[i])) in existing:
                    keep[i] = False
        view_ids, track_ids, pixels = view_ids[keep], track_ids[keep], pixels[keep]
        n = len(view_ids)
        sic = (
            np.ones((n, 2), self.dtype)
            if sqrt_inv_cov is None
            else np.asarray(sqrt_inv_cov, self.dtype).reshape(-1, 2)[keep]
        )
        base = len(self.obs_view)
        self.obs_view = np.concatenate([self.obs_view, view_ids])
        self.obs_track = np.concatenate([self.obs_track, track_ids])
        self.obs_uv = np.vstack([self.obs_uv, pixels])
        self.obs_sqrt_inv_cov = np.vstack([self.obs_sqrt_inv_cov, sic])
        self.obs_depth_prior = np.concatenate(
            [self.obs_depth_prior, np.zeros(n, self.dtype)]
        )
        self.obs_depth_prior_variance = np.concatenate(
            [self.obs_depth_prior_variance, np.zeros(n, self.dtype)]
        )
        for i in range(n):
            row = base + i
            v, t = int(view_ids[i]), int(track_ids[i])
            self._track_obs[t].append(row)
            self._view_track_to_obs[v][t] = row
            if self.track_reference_view[t] == kInvalidViewId:
                self.track_reference_view[t] = v
        return n

    def track_observations(self, track_id: int) -> list[int]:
        return self._track_obs[track_id]

    def tracks_in_view(self, view_id: int) -> list[int]:
        return list(self._view_track_to_obs[view_id].keys())

    # ------------------------------------------------------------- operations

    def set_camera_intrinsics_from_priors(self):
        """Parity: `theia::SetCameraIntrinsicsFromPriors`
        (`sfm/set_camera_intrinsics_from_priors.cc`)."""
        for v in range(self.num_views()):
            g = self.view_group[v]
            self.intrinsics[g] = self.view_priors[v].to_intrinsics(self.dtype)
            self.group_model[g] = self.view_priors[v].camera_intrinsics_model_type

    def normalize(self):
        """Recenter to the point-cloud median and rescale so the robust span
        is 100 (parity: `Reconstruction::Normalize`, `reconstruction.cc` —
        median-centering + 100/median-dist scaling).
        """
        est = self.track_estimated
        if est.sum() < 2:
            return
        pts = self.points[est]
        pts3 = pts[:, :3] / np.where(pts[:, 3:4] == 0, 1.0, pts[:, 3:4])
        median = np.median(pts3, axis=0)
        dists = np.linalg.norm(pts3 - median, axis=-1)
        scale = 100.0 / max(np.median(dists) * 5.0, 1e-12)
        # Apply sim transform: x' = scale * (x - median).
        self.points[est, :3] = (pts3 - median) * scale * pts[:, 3:4]
        self.view_extrinsics[:, :3] = (self.view_extrinsics[:, :3] - median) * scale

    def get_sub_reconstruction(self, view_ids: list[int]) -> "Reconstruction":
        """Parity: `Reconstruction::GetSubReconstruction`
        (`reconstruction.h:172`)."""
        sub = Reconstruction(self.dtype)
        vid_map = {}
        for v in view_ids:
            nv = sub.add_view(
                self.view_names[v],
                group_id=None,
                timestamp=self.view_timestamps[v],
                prior=self.view_priors[v],
            )
            sub.view_extrinsics[nv] = self.view_extrinsics[v]
            sub.view_estimated[nv] = self.view_estimated[v]
            vid_map[v] = nv
        # Every track seen by two kept views, with those observations, in one
        # bulk append (the rows of `add_track` + `add_observation` in turn).
        kept_view = np.zeros(self.num_views(), bool)
        kept_view[list(vid_map)] = True
        tracks, rows = [], []
        for t in range(self.num_tracks()):
            r = [r for r in self._track_obs[t] if kept_view[self.obs_view[r]]]
            if len(r) >= 2:
                tracks.append(t)
                rows.append(r)
        if not tracks:
            return sub
        new_ids = sub.add_tracks_bulk(len(tracks))
        est = self.track_estimated[tracks]
        sub.points[new_ids] = np.where(est[:, None], self.points[tracks], 0.0)
        sub.track_estimated[new_ids] = est
        flat = np.concatenate(rows)
        view_map = np.full(self.num_views(), -1, np.int32)
        view_map[list(vid_map)] = list(vid_map.values())
        sub.add_observations_bulk(
            view_map[self.obs_view[flat]],
            np.repeat(new_ids, [len(r) for r in rows]),
            self.obs_uv[flat],
            self.obs_sqrt_inv_cov[flat],
        )
        return sub
