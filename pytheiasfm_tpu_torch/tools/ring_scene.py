"""The matching slice's full-width scene: calibrated views on a ring.

32 views at 1920x1080 (focal 1.2 x 1920) on a ring of radius 10 around a
point cloud, 12,000 tracks, each seen by the 9 views nearest its anchor
view (about 3,400 track features per view), filled up with random
distractor features to 4096 features of 128-D unit descriptors per view.
Pixel noise 0.5 px; descriptor noise 0.05 per observation. Everything is
made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np

from ..ops.rotation_np import angle_axis_to_rotation_matrix_np

__all__ = [
    "ring_scene",
    "rotation_error_deg",
    "shares_tracks",
    "track_ids_of",
    "view_name",
]

NUM_VIEWS = 32
NUM_TRACKS = 12000
VIEWS_PER_TRACK = 9
WIDTH, HEIGHT = 1920, 1080
FOCAL = 1.2 * WIDTH
NUM_FEATURES = 4096
DESC_DIM = 128
PIXEL_NOISE = 0.5
DESC_NOISE = 0.05


def view_name(v: int) -> str:
    return f"view_{v:02d}"


def shares_tracks(a: int, b: int, num_views: int = NUM_VIEWS) -> bool:
    """Whether views a and b see common tracks (ring distance < 9)."""
    return min(abs(b - a), num_views - abs(b - a)) < VIEWS_PER_TRACK


def ring_scene(
    seed: int = 0, num_tracks: int = NUM_TRACKS, num_features: int = NUM_FEATURES
):
    """Returns (views, rotations, track_ids): views a list of (keypoints
    [F, 2], descriptors [F, 128] f32), rotations the ground-truth
    world-to-camera rotations [V, 3, 3], track_ids a list of [F] int arrays,
    each feature's track (-1 for distractors)."""
    rng = np.random.default_rng(seed)
    V = NUM_VIEWS
    angles = 2 * np.pi * np.arange(V) / V
    centers = np.stack(
        [10 * np.cos(angles), 10 * np.sin(angles), rng.uniform(-0.3, 0.3, V)], -1
    )
    rots = []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        rots.append(np.stack([x, np.cross(z, x), z]))
    rots = np.stack(rots)
    points = rng.uniform([-2.2, -2.2, -1.2], [2.2, 2.2, 1.2], (num_tracks, 3))
    track_desc = rng.normal(size=(num_tracks, DESC_DIM)).astype(np.float32)
    track_desc /= np.linalg.norm(track_desc, axis=1, keepdims=True)
    anchor = rng.integers(V, size=num_tracks)
    half = VIEWS_PER_TRACK // 2
    views, track_ids = [], []
    for v in range(V):
        ring_dist = np.minimum((anchor - v) % V, (v - anchor) % V)
        tracks = np.flatnonzero(ring_dist <= half)
        Xc = (points[tracks] - centers[v]) @ rots[v].T
        uv = FOCAL * Xc[:, :2] / Xc[:, 2:] + [WIDTH / 2, HEIGHT / 2]
        uv += rng.normal(0, PIXEL_NOISE, uv.shape)
        assert np.all((uv >= 0) & (uv < [WIDTH, HEIGHT])) and np.all(Xc[:, 2] > 0)
        desc = track_desc[tracks] + DESC_NOISE * rng.normal(size=(len(tracks), DESC_DIM))
        n_extra = num_features - len(tracks)
        kps = np.concatenate([uv, rng.uniform([0, 0], [WIDTH, HEIGHT], (n_extra, 2))])
        desc = np.concatenate([desc, rng.normal(size=(n_extra, DESC_DIM))]).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        order = rng.permutation(num_features)
        views.append((kps[order], desc[order]))
        track_ids.append(np.concatenate([tracks, np.full(n_extra, -1)])[order])
    return views, rots, track_ids


def rotation_error_deg(angle_axis, R_true) -> float:
    """Angle between an angle-axis rotation and a rotation matrix, degrees."""
    R = angle_axis_to_rotation_matrix_np(angle_axis)
    return float(np.degrees(np.arccos(np.clip((np.trace(R @ R_true.T) - 1) / 2, -1, 1))))


def track_ids_of(keypoints, view_keypoints, view_track_ids):
    """The track ids of `keypoints` [M, 2], each an exact copy of a row of
    the view's `view_keypoints` [F, 2] (as a matcher's correspondences are);
    -2 for a point that is no feature of the view."""
    key = np.ascontiguousarray(view_keypoints, np.float64).view(np.complex128)[:, 0]
    order = np.argsort(key)
    q = np.ascontiguousarray(keypoints, np.float64).view(np.complex128)[:, 0]
    pos = np.clip(np.searchsorted(key[order], q), 0, len(key) - 1)
    idx = order[pos]
    return np.where(key[idx] == q, np.asarray(view_track_ids)[idx], -2)
