"""Plain geometry of the reference: rotations, Theia's pinhole projection
with radial distortion, residuals and cost.

Written from the formulas, in f64, with no code of the program: the
reference judges the program's outputs and takes nothing it derived.
Extrinsics rows are (camera position c, world-to-camera angle-axis w);
intrinsics rows are Theia's pinhole layout (f, aspect, skew, ppx, ppy, k1,
k2, ...). A world point X projects as p = R(w) (X - c), x = p[:2] / p[2],
d = x (1 + k1 |x|^2 + k2 |x|^4), pixel = (f d0 + skew d1 + ppx,
f aspect d1 + ppy).
"""

from __future__ import annotations

import torch


def rotation_matrix(w):
    """R [.., 3, 3] of angle-axis w [.., 3] (Rodrigues; the Taylor terms
    below 1e-6 rad)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    zero = torch.zeros_like(w[..., 0])
    K = torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def project(ext, intr, X):
    """Pixels [.., 2] of world points X [.., 3] seen by cameras ext [.., 6]
    through intrinsics intr [.., >= 7]."""
    p = (rotation_matrix(ext[..., 3:]) @ (X - ext[..., :3])[..., None])[..., 0]
    x = p[..., :2] / p[..., 2:3]
    r2 = torch.sum(x * x, dim=-1)
    d = x * (1.0 + r2 * (intr[..., 5] + intr[..., 6] * r2))[..., None]
    f = intr[..., 0]
    return torch.stack([f * d[..., 0] + intr[..., 2] * d[..., 1] + intr[..., 3],
                        f * intr[..., 1] * d[..., 1] + intr[..., 4]], dim=-1)


def euclidean(points4):
    """World points [N, 3] of homogeneous rows [N, 4] (x, y, z, w)."""
    return points4[:, :3] / points4[:, 3:4]


def residuals(ext, intr, X, obs_view, obs_group, obs_track, obs_uv, chunk=1 << 20):
    """Reprojection residuals [O, 2] (pixel - observation), in row chunks."""
    out = []
    for s in range(0, len(obs_view), chunk):
        v, g, t = obs_view[s:s + chunk], obs_group[s:s + chunk], obs_track[s:s + chunk]
        out.append(project(ext[v], intr[g], X[t]) - obs_uv[s:s + chunk])
    return torch.cat(out) if out else obs_uv.new_zeros((0, 2))


def cost(r):
    """Half the sum of squared residuals (the trivial loss)."""
    return 0.5 * float(torch.sum(r * r))
