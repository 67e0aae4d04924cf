"""Matching data types.

Parity: `theia/matching/keypoint.h:50`,
`keypoints_and_descriptors.h:48`, `indexed_feature_match.h`,
`feature_correspondence.h`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Keypoint",
    "KeypointsAndDescriptors",
    "IndexedFeatureMatch",
    "FeatureCorrespondence",
]


@dataclasses.dataclass
class Keypoint:
    """Parity: `theia::Keypoint` (`keypoint.h:50`)."""

    x: float = 0.0
    y: float = 0.0
    strength: float = 0.0
    scale: float = 0.0
    orientation: float = 0.0


@dataclasses.dataclass
class KeypointsAndDescriptors:
    """Parity: `theia::KeypointsAndDescriptors`
    (`keypoints_and_descriptors.h:48`) — SoA: keypoints [N, 2] pixels,
    descriptors [N, D] float."""

    image_name: str = ""
    keypoints: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2))
    )
    descriptors: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.float32)
    )


@dataclasses.dataclass
class IndexedFeatureMatch:
    """Parity: `theia::IndexedFeatureMatch`."""

    feature1_ind: int = -1
    feature2_ind: int = -1
    distance: float = 0.0


@dataclasses.dataclass
class FeatureCorrespondence:
    """Parity: `theia::FeatureCorrespondence` (two 2D features)."""

    feature1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    feature2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
