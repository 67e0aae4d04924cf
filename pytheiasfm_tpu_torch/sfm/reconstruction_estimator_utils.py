"""Shared helpers for the reconstruction estimators.

Counterpart of `set_reconstruction_from_estimated_poses` and
`num_estimated_views` of the JAX package's
`sfm/reconstruction_estimator_utils.py`
(`theia/sfm/reconstruction_estimator_utils.{h,cc}`). The reprojection and
outlier functions come with the structure port (ROADMAP item A4).
"""

from __future__ import annotations

import numpy as np

__all__ = ["num_estimated_views", "set_reconstruction_from_estimated_poses"]


def num_estimated_views(recon) -> int:
    return int(np.sum(recon.view_estimated))


def set_reconstruction_from_estimated_poses(orientations, positions, recon):
    """Parity: `theia::SetReconstructionFromEstimatedPoses`
    (`reconstruction_estimator_utils.cc`): every view with both a rotation
    and a position estimate becomes an estimated view."""
    for v, aa in orientations.items():
        if v not in positions:
            continue
        recon.view_extrinsics[v, :3] = np.asarray(positions[v])
        recon.view_extrinsics[v, 3:] = np.asarray(aa)
        recon.view_estimated[v] = True
