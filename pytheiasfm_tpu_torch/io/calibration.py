"""Calibration-prior JSON import/export.

Counterpart of the JAX package's `io/calibration.py`
(`theia/io/read_calibration.{h,cc}`, `write_calibration.{h,cc}`, fixture
`data/io/calibration_test.json`): a top-level "priors" list of
{"CameraIntrinsicsPrior": {...}} entries keyed by image name.
"""

from __future__ import annotations

import json

import numpy as np

from ..models.intrinsics import CameraIntrinsicsModelType
from ..sfm.reconstruction import CameraIntrinsicsPrior

__all__ = ["read_calibration", "write_calibration"]

_MODEL_NAMES = {m.name: m for m in CameraIntrinsicsModelType}


def read_calibration(path: str) -> dict[str, CameraIntrinsicsPrior]:
    """Parity: `theia::ReadCalibration` (`read_calibration.h`). Returns
    {image_name: prior}."""
    with open(path) as f:
        doc = json.load(f)
    out = {}
    for entry in doc.get("priors", []):
        p = entry.get("CameraIntrinsicsPrior", entry)
        out[p["image_name"]] = CameraIntrinsicsPrior(
            image_width=p.get("width", p.get("image_width", 0)),
            image_height=p.get("height", p.get("image_height", 0)),
            camera_intrinsics_model_type=_MODEL_NAMES.get(
                p.get("camera_intrinsics_type", "PINHOLE"), CameraIntrinsicsModelType.PINHOLE),
            focal_length=p.get("focal_length"),
            principal_point=tuple(p["principal_point"]) if "principal_point" in p else None,
            aspect_ratio=p.get("aspect_ratio"),
            skew=p.get("skew"),
            radial_distortion=tuple(p.get("radial_distortion_coeffs", ())),
            tangential_distortion=tuple(p.get("tangential_distortion_coeffs", ())),
            position=np.asarray(p["position"]) if "position" in p else None,
            orientation=np.asarray(p["orientation"]) if "orientation" in p else None,
            latitude=p.get("latitude"),
            longitude=p.get("longitude"),
            altitude=p.get("altitude"),
        )
    return out


def write_calibration(path: str, priors: dict[str, CameraIntrinsicsPrior]) -> bool:
    """Parity: `theia::WriteCalibration` (`write_calibration.h`)."""
    entries = []
    for name, p in priors.items():
        entry = {
            "image_name": name,
            "width": p.image_width,
            "height": p.image_height,
            "camera_intrinsics_type": p.camera_intrinsics_model_type.name,
        }
        if p.focal_length is not None:
            entry["focal_length"] = p.focal_length
        if p.principal_point is not None:
            entry["principal_point"] = list(p.principal_point)
        for key in ("aspect_ratio", "skew"):
            if getattr(p, key) is not None:
                entry[key] = getattr(p, key)
        if p.radial_distortion:
            entry["radial_distortion_coeffs"] = list(p.radial_distortion)
        if p.tangential_distortion:
            entry["tangential_distortion_coeffs"] = list(p.tangential_distortion)
        for key in ("latitude", "longitude", "altitude"):
            if getattr(p, key) is not None:
                entry[key] = getattr(p, key)
        entries.append({"CameraIntrinsicsPrior": entry})
    with open(path, "w") as f:
        json.dump({"priors": entries}, f, indent=2)
    return True
