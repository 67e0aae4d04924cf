"""End-to-end scenes: the synthetic global-SfM scene (`synthetic_global.py`)."""
