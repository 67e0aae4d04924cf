"""Feature matching (`theia/matching/`): descriptor matching on the K1
kernel and batched two-view verification."""

from .types import (  # noqa: F401
    FeatureCorrespondence,
    IndexedFeatureMatch,
    Keypoint,
    KeypointsAndDescriptors,
)
from .options import FeatureMatcherOptions  # noqa: F401
from .brute_force import (  # noqa: F401
    match_descriptor_pair,
    match_descriptors_batch,
    match_descriptors_batch_auto,
)
from .streaming_matcher import (  # noqa: F401
    match_descriptors_batch_streaming,
    streaming_top2,
    streaming_top2_reference,
)
from .matcher import BruteForceFeatureMatcher, FeatureMatcher  # noqa: F401
from .graph_match import graph_match  # noqa: F401
from .database import (  # noqa: F401
    FeaturesAndMatchesDatabase,
    InMemoryFeaturesAndMatchesDatabase,
)
from .fisher_vector import FisherVectorExtractor  # noqa: F401
from .guided_epipolar import GuidedEpipolarMatcher, guided_epipolar_match  # noqa: F401
