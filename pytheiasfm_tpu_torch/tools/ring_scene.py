"""The matching slice's full-width scene: calibrated views on a ring.

32 views at 1920x1080 (focal 1.2 x 1920) on a ring of radius 10 around a
point cloud, 12,000 tracks, each seen by the 9 views nearest its anchor
view (about 3,400 track features per view), filled up with random
distractor features to 4096 features of 128-D unit descriptors per view.
Pixel noise 0.5 px; descriptor noise 0.05 per observation. Everything is
made with numpy from a seed.

Every camera looks at the centre of the cloud, so all principal axes meet
there: the configuration in which Bougnoux's focal lengths from a
fundamental matrix are undefined. `look_jitter` > 0 moves each camera's
look-at point off the centre by a draw from the seed (uniform in a box of
that half-width, a separate stream, so the rest of the scene is unchanged),
for the uncalibrated path.
"""

from __future__ import annotations

import numpy as np

from ..ops.rotation_np import angle_axis_to_rotation_matrix_np

__all__ = [
    "UNCALIBRATED_LOOK_JITTER",
    "covisible_correspondences",
    "focal_and_rotation_errors",
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
# The look-at jitter of the uncalibrated runs (metres, x / y / z), chosen
# on the CPU (`tests/torch_uncalibrated_study.py`): with it the 8-point F
# on all of a pair's ground-truth correspondences gives the focal length to
# a median 1.1% (no jitter: no focal length at all); larger boxes that keep
# the points in frame do no better, for that fit or for the minimal
# samples of RANSAC (a median 11-13% on 64 pairs).
UNCALIBRATED_LOOK_JITTER = (0.3, 0.3, 0.6)


def view_name(v: int) -> str:
    return f"view_{v:02d}"


def shares_tracks(a: int, b: int, num_views: int = NUM_VIEWS) -> bool:
    """Whether views a and b see common tracks (ring distance < 9)."""
    return min(abs(b - a), num_views - abs(b - a)) < VIEWS_PER_TRACK


def ring_scene(
    seed: int = 0, num_tracks: int = NUM_TRACKS, num_features: int = NUM_FEATURES,
    look_jitter=0.0,
):
    """Returns (views, rotations, track_ids): views a list of (keypoints
    [F, 2], descriptors [F, 128] f32), rotations the ground-truth
    world-to-camera rotations [V, 3, 3], track_ids a list of [F] int arrays,
    each feature's track (-1 for distractors). `look_jitter`: the half-width
    (metres; a number, or one for each axis) of the box the look-at points
    are drawn from (0: the centre)."""
    rng = np.random.default_rng(seed)
    V = NUM_VIEWS
    angles = 2 * np.pi * np.arange(V) / V
    centers = np.stack(
        [10 * np.cos(angles), 10 * np.sin(angles), rng.uniform(-0.3, 0.3, V)], -1
    )
    targets = np.zeros((V, 3))
    if np.any(np.asarray(look_jitter) > 0):
        half = np.broadcast_to(np.asarray(look_jitter, np.float64), (3,))
        targets = np.random.default_rng([seed, 1]).uniform(-half, half, (V, 3))
    rots = []
    for c, target in zip(centers, targets):
        z = (target - c) / np.linalg.norm(target - c)
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


def covisible_correspondences(views, track_ids):
    """The ground-truth correspondences of every pair of views that shares
    tracks: (pairs [(a, b)], points1, points2 [P, K, 2] pixels, mask
    [P, K]), each pair's rows first."""
    pairs = [(a, b) for a in range(NUM_VIEWS) for b in range(a + 1, NUM_VIEWS)
             if shares_tracks(a, b)]
    rows = []
    for a, b in pairs:
        common, ia, ib = np.intersect1d(track_ids[a], track_ids[b], return_indices=True)
        keep = common >= 0
        rows.append((views[a][0][ia[keep]], views[b][0][ib[keep]]))
    K = max(len(r[0]) for r in rows)
    points1 = np.zeros((len(pairs), K, 2))
    points2 = np.zeros((len(pairs), K, 2))
    mask = np.zeros((len(pairs), K), bool)
    for i, (x1, x2) in enumerate(rows):
        points1[i, : len(x1)] = x1
        points2[i, : len(x2)] = x2
        mask[i, : len(x1)] = True
    return pairs, points1, points2, mask


def focal_and_rotation_errors(pairs, focal1, focal2, rotations, rots):
    """(median |f / FOCAL - 1| over both views of every pair, median
    relative-rotation error in degrees) of estimated focal lengths [P] and
    relative rotations [P, 3, 3] of `pairs` against the scene's `rots`."""
    f = np.concatenate([np.asarray(focal1, np.float64), np.asarray(focal2, np.float64)])
    errs = [float(np.degrees(np.arccos(np.clip(
        (np.trace(np.asarray(R, np.float64) @ (rots[b] @ rots[a].T).T) - 1) / 2, -1, 1))))
        for R, (a, b) in zip(rotations, pairs)]
    return float(np.median(np.abs(f / FOCAL - 1))), float(np.median(errs))
