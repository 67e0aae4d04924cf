"""Camera models: the eight intrinsics models (`intrinsics.py`) and
extrinsics and projection (`camera.py`)."""

from . import camera, intrinsics  # noqa: F401
from .intrinsics import CameraIntrinsicsModelType  # noqa: F401
