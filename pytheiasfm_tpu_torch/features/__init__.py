"""Feature extraction on the device: the port's SIFT (`sift.py`), the
counterpart of the JAX package's `features/`."""

from .sift import SiftParams, detect_and_describe, load_grayscale  # noqa: F401
