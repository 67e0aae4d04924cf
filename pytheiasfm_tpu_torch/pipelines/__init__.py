"""End-to-end pipelines: the synthetic global-SfM scene
(`synthetic_global.py`), images to reconstruction (`images.py`) and feature
tracks from a file to a reconstruction and its ATE (`fountain.py`)."""

from . import fountain, synthetic_global  # noqa: F401
