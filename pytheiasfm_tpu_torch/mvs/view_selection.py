"""MVSNet-style view selection for multi-view stereo.

Counterpart of the JAX package's `mvs/view_selection.py`
(`theia/mvs/view_selection_mvsnet.{h,cc}`, `view_selection_mvsnet.h:50-53`):
each view pair (i, j) scores the sum, over the scene points p both see, of
a piecewise Gaussian of the angle the two camera centres subtend at p
(Yao et al., "MVSNet", ECCV 2018):

    score(i, j) = sum_p exp(-(theta_ijp - theta0)^2 / (2 sigma^2)),
    sigma = sigma1 if theta <= theta0 else sigma2.

The reference loops over view pairs and intersects track lists; here a
[V, T] incidence matrix and the per-track ray angles go through [Tc, V, V]
batched products on `device` (None: the CUDA card) in f32, chunked over
tracks; each chunk's sums are accumulated in f64, as the JAX function does
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device

__all__ = ["view_selection_mvsnet", "pairwise_view_scores"]


def _score_chunk(centers, points, incidence, theta0, sigma1, sigma2):
    """centers [V, 3], points [Tc, 3], incidence [V, Tc] (f32). Returns
    ([V, V] score sum, [V, V] co-visibility count) of the chunk."""
    rays = centers[None, :, :] - points[:, None, :]  # [Tc, V, 3]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-12)
    cos = torch.bmm(rays, rays.mT)  # [Tc, V, V]
    theta = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    sigma = torch.where(theta <= theta0, sigma1, sigma2)
    w = torch.exp(-((theta - theta0) ** 2) / (2.0 * sigma * sigma))
    inc = incidence.T
    both = inc[:, :, None] * inc[:, None, :]  # [Tc, V, V]
    return torch.sum(w * both, dim=0), torch.sum(both, dim=0)


def pairwise_view_scores(centers, points, incidence, theta0: float = 5.0, sigma1: float = 1.0,
                         sigma2: float = 10.0, chunk: int = 512, device=None):
    """Dense [V, V] MVSNet pair scores and co-visibility counts (f64 numpy).

    centers [V, 3]; points [T, 3]; incidence [V, T] bool (view sees track).
    """
    device = default_device(device)
    V, T = centers.shape[0], points.shape[0]
    f32 = torch.float32
    c = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    inc = torch.as_tensor(np.asarray(incidence, np.float32), device=device)
    args = [torch.tensor(x, dtype=f32, device=device) for x in (theta0, sigma1, sigma2)]
    score = torch.zeros((V, V), dtype=torch.float64, device=device)
    covis = torch.zeros((V, V), dtype=torch.float64, device=device)
    for s in range(0, T, chunk):
        sc, cv = _score_chunk(c, pts[s:s + chunk], inc[:, s:s + chunk], *args)
        score += sc.double()
        covis += cv.double()
    return score.cpu().numpy(), covis.cpu().numpy()


def view_selection_mvsnet(recon, num_neighbors: int, theta0: float = 5.0, sigma1: float = 1.0,
                          sigma2: float = 10.0, min_common_tracks: int = 10, device=None):
    """Parity: `theia::ViewSelectionMVSNet(reconstruction, num_neighbors,
    theta0, sigma1, sigma2)` (`view_selection_mvsnet.h:50`), on `device`
    (None: the CUDA card). Returns {view_id: [(score, neighbor_view_id),
    ...]}, each list by descending score, at most `num_neighbors` long.
    A candidate needs >= `min_common_tracks` co-visible tracks (the
    reference's `ViewGraphFromReconstruction(recon, 10, ...)`)."""
    device = default_device(device)
    V = recon.num_views()
    est_views = np.flatnonzero(np.asarray(recon.view_estimated))
    est_tracks = np.flatnonzero(np.asarray(recon.track_estimated))
    if len(est_views) < 2 or len(est_tracks) == 0:
        return {int(v): [] for v in est_views}

    tmap = -np.ones(recon.num_tracks(), np.int64)
    tmap[est_tracks] = np.arange(len(est_tracks))
    vmap = -np.ones(V, np.int64)
    vmap[est_views] = np.arange(len(est_views))
    obs_view = np.asarray(recon.obs_view)
    obs_track = np.asarray(recon.obs_track)
    ok = (vmap[obs_view] >= 0) & (tmap[obs_track] >= 0)
    incidence = np.zeros((len(est_views), len(est_tracks)), bool)
    incidence[vmap[obs_view[ok]], tmap[obs_track[ok]]] = True

    pts4 = np.asarray(recon.points)[est_tracks]
    w = np.where(pts4[:, 3] == 0, 1.0, pts4[:, 3])
    points = pts4[:, :3] / w[:, None]
    centers = np.asarray(recon.view_extrinsics)[est_views, :3]
    score, covis = pairwise_view_scores(centers, points, incidence, theta0, sigma1, sigma2,
                                        device=device)

    out = {}
    for i, v in enumerate(est_views):
        cand = np.flatnonzero((covis[i] >= min_common_tracks)
                              & (np.arange(len(est_views)) != i))
        order = cand[np.argsort(-score[i, cand])][:num_neighbors]
        out[int(v)] = [(float(score[i, j]), int(est_views[j])) for j in order]
    return out
