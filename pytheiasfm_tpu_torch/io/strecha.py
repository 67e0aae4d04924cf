"""Strecha MVS dataset reader (`*.camera` ground-truth files).

Counterpart of the JAX package's `io/strecha.py`
(`theia/io/read_strecha_dataset.{h,cc}`): each `<image>.camera` file holds
K (3 rows), a zero line, R stored column-major, the camera position and
the image size. All cameras share one PINHOLE intrinsics group and are
estimated.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..ops import rotation as rotops
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction

__all__ = ["read_strecha_dataset"]


def read_strecha_dataset(dataset_directory: str) -> Reconstruction:
    """Parity: `theia::ReadStrechaDataset` (`read_strecha_dataset.cc`)."""
    camera_files = sorted(glob.glob(os.path.join(dataset_directory, "*.camera")))
    if not camera_files:
        raise FileNotFoundError(f"no .camera files in {dataset_directory}")
    recon = Reconstruction()
    Rs = []
    for idx, path in enumerate(camera_files):
        with open(path) as f:
            vals = np.array(f.read().split(), float)
        K = vals[0:9].reshape(3, 3)
        # vals[9:12] is the zero line; R is stored column-major.
        Rs.append(vals[12:21].reshape(3, 3).T)
        prior = CameraIntrinsicsPrior(
            image_width=int(vals[24]),
            image_height=int(vals[25]),
            focal_length=float(K[0, 0]),
            principal_point=(float(K[0, 2]), float(K[1, 2])),
            aspect_ratio=float(K[1, 1] / K[0, 0]),
            skew=float(K[0, 1]),
        )
        v = recon.add_view(os.path.basename(path).replace(".camera", ""), group_id=0,
                           timestamp=float(idx), prior=prior)
        recon.view_extrinsics[v, :3] = vals[21:24]
        recon.view_estimated[v] = True
        if v == 0:
            recon.intrinsics[0] = prior.to_intrinsics(recon.dtype)
    recon.view_extrinsics[:, 3:] = rotops.rotation_matrix_to_angle_axis(
        torch.as_tensor(np.stack(Rs), dtype=torch.float64)).numpy()
    return recon
