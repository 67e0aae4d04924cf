"""Carry the scene state of the JAX package over to the port.

The system has no weights: its state is the scene (descriptors, keypoints,
camera priors, the reconstruction and the view graph) and the options.
These functions turn the JAX package's host objects into the port's by
field name, without importing the JAX package, so that both packages can
run the same inputs. Any object with the same field names converts (duck
typing); numpy arrays are copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .matching.options import FeatureMatcherOptions
from .matching.types import KeypointsAndDescriptors
from .models.intrinsics import CameraIntrinsicsModelType
from .sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from .sfm.reconstruction_builder import ImagePairMatch
from .sfm.two_view import EstimateTwoViewInfoOptions
from .sfm.two_view_match_geometric_verification import (
    TwoViewMatchGeometricVerificationOptions,
)
from .sfm.view_graph import TwoViewInfo, ViewGraph

__all__ = [
    "camera_intrinsics_prior",
    "feature_matcher_options",
    "image_pair_match",
    "keypoints_and_descriptors",
    "reconstruction",
    "two_view_info",
    "two_view_match_geometric_verification_options",
    "view_graph",
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


def view_graph(graph) -> ViewGraph:
    """The same edges, in the same insertion order, each `TwoViewInfo`
    copied. Edges are stored already oriented (lower view id first), so
    they are inserted as they are."""
    out = ViewGraph()
    for (a, b), info in graph.edges.items():
        out.add_edge(int(a), int(b), two_view_info(info))
    return out


def reconstruction(recon) -> Reconstruction:
    """Every field of a `Reconstruction`: the views with their priors and
    intrinsics groups, the tracks and the observation table, with the
    track -> observations and view -> {track: observation} indexes."""
    out = Reconstruction(recon.dtype)
    for name, value in vars(recon).items():
        if name == "view_priors":
            value = [camera_intrinsics_prior(p) for p in value]
        elif name == "group_model":
            value = [CameraIntrinsicsModelType(int(m)) for m in value]
        elif name == "_track_obs":
            value = [list(rows) for rows in value]
        elif name == "_view_track_to_obs":
            value = [dict(d) for d in value]
        elif isinstance(value, (dict, list)):
            value = type(value)(value)
        else:
            value = _copy(value)
        setattr(out, name, value)
    return out
