"""A bundle-adjustment problem at the size of a BAL problem, from a seed.

Cameras on a ring around the scene, as in the ring scene, looking at the
origin; points uniform in a cube inside it. Every camera has its own focal
length and radial distortion (k1, k2), as the cameras of an internet photo
collection do, and the Theia pinhole model projects (slots f, aspect, skew,
ppx, ppy, k1, k2; the principal point at the origin, as BAL's centred
pixel coordinates have it). Each track is seen by `length` distinct cameras
within `neighborhood` of a centre camera on the ring.

The track lengths follow a truncated geometric law on [min_length,
max_length] whose counts sum to `tracks` and whose lengths sum to
`observations` exactly. `problem_seed` draws the problem: which track gets
which length, the geometry, the intrinsics, the noise and the start state.
The run's seed only puts its tracks in another order (their labels and the
rows of their observations), so every seed poses the same problem and asks
the same work of a solver; the cameras keep their order, on which a
solver's block preconditioner may depend.
"""

from __future__ import annotations

import numpy as np


def length_histogram(tracks, observations, min_length, max_length):
    """Counts [max_length - min_length + 1] of tracks of each length: a
    geometric law fitted to the mean observations / tracks by bisection,
    rounded, then moved one track at a time between neighbouring lengths
    until both sums are exact."""
    lengths = np.arange(min_length, max_length + 1)
    target = observations / tracks

    def probs(a):
        w = np.exp(-a * (lengths - min_length))
        return w / w.sum()

    lo, hi = -5.0, 5.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if probs(mid) @ lengths > target:
            lo = mid
        else:
            hi = mid
    counts = np.floor(probs(0.5 * (lo + hi)) * tracks).astype(np.int64)
    counts[0] += tracks - counts.sum()
    excess = int(counts @ lengths) - observations
    i = 0
    while excess != 0:
        k = i % (len(lengths) - 1)
        if excess > 0 and counts[k + 1] > 0:  # one track one observation shorter
            counts[k + 1] -= 1
            counts[k] += 1
            excess -= 1
        elif excess < 0 and counts[k] > 0:  # one track one observation longer
            counts[k] -= 1
            counts[k + 1] += 1
            excess += 1
        i += 1
    return lengths, counts


def rodrigues(aa):
    """Rotation matrices [N, 3, 3] of angle-axis vectors [N, 3]."""
    theta = np.linalg.norm(aa, axis=-1)
    small = theta < 1e-12
    k = aa / np.where(small, 1.0, theta)[:, None]
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K[:, 1, 0], K[:, 2, 0], K[:, 2, 1] = k[:, 2], -k[:, 1], k[:, 0]
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    return np.eye(3) + s * K + (1.0 - c) * (K @ K)


def angle_axis(R):
    """Angle-axis [N, 3] of rotation matrices [N, 3, 3] (angles below pi)."""
    cos = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    s = np.sin(theta)
    scale = np.where(s < 1e-12, 0.5, theta / (2.0 * np.where(s < 1e-12, 1.0, s)))
    return w * scale[:, None]


def project(ext, intr, X):
    """Pixels [N, 2] of world points X [N, 3] in cameras ext [N, 6]
    (position, angle-axis) with intrinsics intr [N, 10] (Theia pinhole)."""
    p = np.einsum("nij,nj->ni", rodrigues(ext[:, 3:]), X - ext[:, :3])
    x = p[:, :2] / p[:, 2:3]
    r2 = np.sum(x * x, axis=1)
    x = x * (1.0 + r2 * (intr[:, 5] + intr[:, 6] * r2))[:, None]
    f = intr[:, 0]
    return np.stack([f * x[:, 0] + intr[:, 2] * x[:, 1] + intr[:, 3],
                     f * intr[:, 1] * x[:, 1] + intr[:, 4]], axis=1)


def build(views, tracks, observations, min_length, max_length, neighborhood, noise_px,
          focal_range, k1_range, k2_range, start_position_sigma, start_rotation_sigma_deg,
          start_focal_sigma, start_k1_sigma, start_k2_sigma, start_point_sigma, problem_seed,
          seed):
    """Ground truth (`positions`, `aa`, `intrinsics` [V, 10], `points`), the
    observations (`obs_view`, `obs_track`, `obs_uv`, grouped by track) and
    the start state (`start_ext` [V, 6], `start_intr`, `start_points`)."""
    V, T = views, tracks
    rng = np.random.default_rng(problem_seed)
    angles = np.sort(rng.uniform(0, 2 * np.pi, V))
    positions = np.stack([10 * np.cos(angles), 10 * np.sin(angles), rng.normal(size=V) * 0.5], -1)
    z = -positions / np.linalg.norm(positions, axis=1, keepdims=True)
    x = np.cross(np.broadcast_to([0.0, 0.0, 1.0], z.shape), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=1)
    aa = angle_axis(R)
    intr = np.zeros((V, 10))
    intr[:, 0] = rng.uniform(*focal_range, size=V)
    intr[:, 1] = 1.0
    intr[:, 5] = rng.uniform(*k1_range, size=V)
    intr[:, 6] = rng.uniform(*k2_range, size=V)
    points = rng.uniform(-3, 3, size=(T, 3))

    lengths, counts = length_histogram(T, observations, min_length, max_length)
    track_len = rng.permutation(np.repeat(lengths, counts))
    # Distinct views a track: its centre, then the first offsets of a random
    # order of the 2 * neighborhood others.
    others = np.concatenate([np.arange(-neighborhood, 0), np.arange(1, neighborhood + 1)])
    order = np.argsort(rng.random((T, len(others))), axis=1)[:, :max_length - 1]
    offs = np.concatenate([np.zeros((T, 1), np.int64), others[order]], axis=1)
    centers = rng.integers(0, V, size=T)
    mask = np.arange(max_length)[None, :] < track_len[:, None]
    obs_view = ((centers[:, None] + offs) % V)[mask].astype(np.int32)
    obs_track = np.broadcast_to(np.arange(T, dtype=np.int32)[:, None], mask.shape)[mask]
    ext = np.concatenate([positions, aa], axis=1)
    uv = project(ext[obs_view], intr[obs_view], points[obs_track])
    uv += rng.normal(size=uv.shape) * noise_px

    turn = rng.normal(size=(V, 3)) * np.deg2rad(start_rotation_sigma_deg)
    start_R = np.einsum("nij,njk->nik", rodrigues(turn), R)
    start_ext = np.concatenate([positions + rng.normal(size=(V, 3)) * start_position_sigma,
                                angle_axis(start_R)], axis=1)
    start_intr = intr.copy()
    start_intr[:, 0] *= 1.0 + rng.normal(size=V) * start_focal_sigma
    start_intr[:, 5] += rng.normal(size=V) * start_k1_sigma
    start_intr[:, 6] += rng.normal(size=V) * start_k2_sigma
    start_points = points + rng.normal(size=(T, 3)) * start_point_sigma

    # The seed's order of the tracks: new track j is track order[j].
    order = np.random.default_rng([seed, 2]).permutation(T)
    label = np.empty(T, np.int32)
    label[order] = np.arange(T, dtype=np.int32)
    rows = np.argsort(label[obs_track], kind="stable")
    obs_view, obs_track, uv = obs_view[rows], label[obs_track][rows], uv[rows]
    points, start_points = points[order], start_points[order]
    return dict(positions=positions, aa=aa, intrinsics=intr, points=points,
                obs_view=obs_view, obs_track=obs_track, obs_uv=uv,
                start_ext=start_ext, start_intr=start_intr, start_points=start_points)
