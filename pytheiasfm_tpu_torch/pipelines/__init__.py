"""End-to-end pipelines: the synthetic global-SfM scene
(`synthetic_global.py`) and images to reconstruction (`images.py`)."""
