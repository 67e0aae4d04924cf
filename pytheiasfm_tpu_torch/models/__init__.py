"""Camera models: PINHOLE intrinsics (`intrinsics.py`) and extrinsics and
projection (`camera.py`); the other seven intrinsics models wait (A1b)."""
