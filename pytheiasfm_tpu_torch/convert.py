"""Carry the scene state of the JAX package over to the port.

The system has no weights: its state is the scene (descriptors, keypoints,
camera priors) and the options. These functions turn the JAX package's host
objects into the port's by field name, without importing the JAX package,
so that both packages can run the same inputs. Any object with the same
field names converts (duck typing); numpy arrays are copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .matching.options import FeatureMatcherOptions
from .matching.types import KeypointsAndDescriptors
from .models.intrinsics import CameraIntrinsicsModelType
from .sfm.reconstruction import CameraIntrinsicsPrior
from .sfm.reconstruction_builder import ImagePairMatch
from .sfm.two_view import EstimateTwoViewInfoOptions
from .sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions,
)
from .sfm.view_graph import TwoViewInfo

__all__ = [
    "camera_intrinsics_prior",
    "feature_matcher_options",
    "image_pair_match",
    "keypoints_and_descriptors",
    "two_view_info",
    "two_view_match_geometric_verification_options",
]


def _copy(value):
    return np.array(value) if isinstance(value, np.ndarray) else value


def _fields(obj, cls, **converted):
    """Construct `cls` from the same-named attributes of `obj`, with the
    nested fields given in `converted`."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in converted:
            kwargs[f.name] = converted[f.name]
        elif hasattr(obj, f.name):
            kwargs[f.name] = _copy(getattr(obj, f.name))
    return cls(**kwargs)


def camera_intrinsics_prior(prior) -> CameraIntrinsicsPrior:
    return _fields(
        prior,
        CameraIntrinsicsPrior,
        camera_intrinsics_model_type=CameraIntrinsicsModelType(
            int(prior.camera_intrinsics_model_type)
        ),
    )


def two_view_match_geometric_verification_options(
    gv,
) -> TwoViewMatchGeometricVerificationOptions:
    return _fields(
        gv,
        TwoViewMatchGeometricVerificationOptions,
        estimate_twoview_info_options=_fields(
            gv.estimate_twoview_info_options, EstimateTwoViewInfoOptions
        ),
    )


def feature_matcher_options(options) -> FeatureMatcherOptions:
    return _fields(
        options,
        FeatureMatcherOptions,
        geometric_verification_options=two_view_match_geometric_verification_options(
            options.geometric_verification_options
        ),
    )


def two_view_info(info) -> TwoViewInfo:
    return _fields(info, TwoViewInfo)


def image_pair_match(match) -> ImagePairMatch:
    return _fields(match, ImagePairMatch, twoview_info=two_view_info(match.twoview_info))


def keypoints_and_descriptors(features) -> KeypointsAndDescriptors:
    return _fields(features, KeypointsAndDescriptors)
