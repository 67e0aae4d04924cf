"""Matcher output record `ImagePairMatch`.

Copy of `ImagePairMatch` from the JAX package's `sfm/reconstruction_builder.py`;
the builder itself belongs to a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .view_graph import TwoViewInfo

__all__ = ["ImagePairMatch"]


@dataclasses.dataclass
class ImagePairMatch:
    """Parity: `theia::ImagePairMatch` (`matching/image_pair_match.h`)."""

    image1: str = ""
    image2: str = ""
    twoview_info: TwoViewInfo = dataclasses.field(default_factory=TwoViewInfo)
    correspondences1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2))
    )  # pixels in image 1
    correspondences2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2))
    )  # pixels in image 2
