"""Features-and-matches key-value store.

Re-design of `theia/matching/
features_and_matches_database.h:51-99` (abstract KV interface) and
`in_memory_features_and_matches_database.h:53` (mutex-guarded dict — the
only implementation the reference kept after dropping RocksDB).
"""

from __future__ import annotations

import pickle
import threading

from ..sfm.reconstruction import CameraIntrinsicsPrior
from .types import KeypointsAndDescriptors

__all__ = ["FeaturesAndMatchesDatabase", "InMemoryFeaturesAndMatchesDatabase"]


class FeaturesAndMatchesDatabase:
    """Abstract interface (parity: `features_and_matches_database.h:51`)."""

    def contains_camera_intrinsics_prior(self, image_name: str) -> bool:
        raise NotImplementedError

    def get_camera_intrinsics_prior(self, image_name: str) -> CameraIntrinsicsPrior:
        raise NotImplementedError

    def put_camera_intrinsics_prior(self, image_name: str, prior) -> None:
        raise NotImplementedError

    def contains_features(self, image_name: str) -> bool:
        raise NotImplementedError

    def get_features(self, image_name: str) -> KeypointsAndDescriptors:
        raise NotImplementedError

    def put_features(self, image_name: str, features) -> None:
        raise NotImplementedError

    def get_image_pair_match(self, name1: str, name2: str):
        raise NotImplementedError

    def put_image_pair_match(self, name1: str, name2: str, match) -> None:
        raise NotImplementedError

    def image_names_of_camera_intrinsics_priors(self) -> list[str]:
        raise NotImplementedError

    def image_names_of_features(self) -> list[str]:
        raise NotImplementedError

    def image_names_of_matches(self) -> list[tuple[str, str]]:
        raise NotImplementedError


class InMemoryFeaturesAndMatchesDatabase(FeaturesAndMatchesDatabase):
    """Parity: `theia::InMemoryFeaturesAndMatchesDatabase`
    (`in_memory_features_and_matches_database.h:53`) + the reference's
    save/load-to-disk hooks (pickle stands in for cereal)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._priors: dict[str, CameraIntrinsicsPrior] = {}
        self._features: dict[str, KeypointsAndDescriptors] = {}
        self._matches: dict[tuple[str, str], object] = {}

    # priors
    def contains_camera_intrinsics_prior(self, image_name):
        with self._lock:
            return image_name in self._priors

    def get_camera_intrinsics_prior(self, image_name):
        with self._lock:
            return self._priors[image_name]

    def put_camera_intrinsics_prior(self, image_name, prior):
        with self._lock:
            self._priors[image_name] = prior

    # features
    def contains_features(self, image_name):
        with self._lock:
            return image_name in self._features

    def get_features(self, image_name):
        with self._lock:
            return self._features[image_name]

    def put_features(self, image_name, features):
        with self._lock:
            self._features[image_name] = features

    # matches
    def get_image_pair_match(self, name1, name2):
        with self._lock:
            return self._matches[(name1, name2)]

    def put_image_pair_match(self, name1, name2, match):
        with self._lock:
            self._matches[(name1, name2)] = match

    def image_names_of_camera_intrinsics_priors(self):
        with self._lock:
            return list(self._priors)

    def image_names_of_features(self):
        with self._lock:
            return list(self._features)

    def image_names_of_matches(self):
        with self._lock:
            return list(self._matches)

    def num_images(self) -> int:
        with self._lock:
            return len(self._features)

    def num_matches(self) -> int:
        with self._lock:
            return len(self._matches)

    # persistence (reference: SaveMatchesAndGeometry / ReadFromFile)
    def save(self, path: str) -> None:
        with self._lock, open(path, "wb") as f:
            pickle.dump(
                {
                    "priors": self._priors,
                    "features": self._features,
                    "matches": self._matches,
                },
                f,
            )

    def load(self, path: str) -> None:
        with open(path, "rb") as f:
            data = pickle.load(f)
        with self._lock:
            self._priors = data["priors"]
            self._features = data["features"]
            self._matches = data["matches"]
