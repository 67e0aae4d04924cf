"""The global SfM pipeline.

Counterpart of the JAX package's `sfm/global_estimator.py`
(`theia/sfm/global_reconstruction_estimator.{h,cc}`). Ported so far: the
initial view-graph filter and the pairwise-translation refinement, the
estimator's own steps 1 and 5; `tools/global_pose.py` runs steps 1-7 in
`estimate`'s order. `estimate`, the structure and the bundle-adjustment
loop come with ROADMAP items A4-A8.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..global_pose.pairwise_translation import (
    optimize_relative_positions_with_known_rotations,
)
from ..models import camera as cam
from .estimator_options import ReconstructionEstimatorOptions

__all__ = ["GlobalReconstructionEstimator"]


class GlobalReconstructionEstimator:
    """Parity: `theia::GlobalReconstructionEstimator`
    (`global_reconstruction_estimator.h:71-90`). `device`: where the
    numeric stages run (None: the CUDA card)."""

    def __init__(self, options: ReconstructionEstimatorOptions | None = None, device=None):
        self.options = options or ReconstructionEstimatorOptions()
        self.device = default_device(device)

    def _filter_initial_view_graph(self, view_graph, recon) -> bool:
        """Parity: `FilterInitialViewGraph`
        (`global_reconstruction_estimator.cc:304-325`)."""
        opt = self.options
        to_remove = [
            (i, j)
            for (i, j), info in view_graph.edges.items()
            if info.num_verified_matches < opt.min_num_two_view_inliers
        ]
        for i, j in to_remove:
            view_graph.remove_edge(i, j)
        keep = set(view_graph.largest_connected_component_ids())
        for v in list(view_graph.view_ids()):
            if v not in keep:
                view_graph.remove_view(v)
        return view_graph.num_edges() >= 1

    def _optimize_pairwise_translations(self, view_graph, orientations, recon):
        """Parity: `OptimizePairwiseTranslations`
        (`global_reconstruction_estimator.cc:195-202`): refine each edge's
        relative position on the epipolar constraint over the views' shared
        (normalized) features, batched over all edges."""
        edges = [
            (i, j)
            for (i, j) in view_graph.edges
            if i in orientations and j in orientations
        ]
        if not edges:
            return
        # Shared-track correspondences per edge, as observation rows.
        corr = []
        for (i, j) in edges:
            vi = recon._view_track_to_obs[i]
            vj = recon._view_track_to_obs[j]
            common = [t for t in vi if t in vj]
            corr.append(([vi[t] for t in common], [vj[t] for t in common]))
        K = max((len(c[0]) for c in corr), default=0)
        if K < 5:
            return
        Kp = 8
        while Kp < K:
            Kp *= 2
        E = len(edges)
        dtype = np.float64
        x1 = np.zeros((E, Kp, 2), dtype)
        x2 = np.zeros((E, Kp, 2), dtype)
        mask = np.zeros((E, Kp), bool)
        rot1 = np.zeros((E, 3), dtype)
        rot2 = np.zeros((E, 3), dtype)
        init = np.zeros((E, 3), dtype)

        # Normalize the whole observation table once per intrinsics group.
        norm_uv = np.zeros((len(recon.obs_view), 2), dtype)
        obs_group = recon.view_group[recon.obs_view]
        for g in np.unique(obs_group):
            rows = np.nonzero(obs_group == g)[0]
            ray = cam.pixel_to_normalized_batch(
                torch.as_tensor(recon.intrinsics[g], device=self.device),
                torch.as_tensor(recon.obs_uv[rows], device=self.device),
                int(recon.group_model[g]),
            )
            norm_uv[rows] = (ray[:, :2] / ray[:, 2:3]).cpu().numpy()

        for e, ((i, j), (rows_i, rows_j)) in enumerate(zip(edges, corr)):
            k = len(rows_i)
            if k:
                x1[e, :k] = norm_uv[rows_i]
                x2[e, :k] = norm_uv[rows_j]
                mask[e, :k] = True
            rot1[e] = orientations[i]
            rot2[e] = orientations[j]
            init[e] = np.asarray(view_graph.get_edge(i, j).position_2)

        refined, ok = optimize_relative_positions_with_known_rotations(
            *(torch.as_tensor(a, device=self.device) for a in (rot1, rot2, x1, x2, mask, init))
        )
        refined = refined.cpu().numpy()
        ok = ok.cpu().numpy()
        for e, (i, j) in enumerate(edges):
            if ok[e]:
                view_graph.get_edge(i, j).position_2 = refined[e]
