"""Camera models: the eight intrinsics models (`intrinsics.py`) and
extrinsics and projection (`camera.py`)."""
