"""User-facing pipeline entry: images + matches in, reconstructions out.

Counterpart of the JAX package's `sfm/reconstruction_builder.py`
(`theia/sfm/reconstruction_builder.{h,cc}`, `reconstruction_builder.h:131-225`,
options `:59-127`): `add_image*` / `add_two_view_match` populate the scene
containers; `build_reconstruction` builds tracks (host union-find) and
repeatedly runs the configured estimator on the builder's device,
extracting successive models until no more views can be estimated
(`reconstruction_builder.h:181-187`). Also holds the matcher's output
record `ImagePairMatch`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import default_device
from .estimator_options import ReconstructionEstimatorOptions
from .reconstruction import CameraIntrinsicsPrior, Reconstruction
from .reconstruction_estimator import create_reconstruction_estimator
from .reconstruction_estimator_utils import create_estimated_subreconstruction
from .track_builder import TrackBuilder
from .view_graph import TwoViewInfo, ViewGraph

__all__ = ["ImagePairMatch", "ReconstructionBuilderOptions", "ReconstructionBuilder"]


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


@dataclasses.dataclass
class ReconstructionBuilderOptions:
    """Parity: `theia::ReconstructionBuilderOptions`
    (`reconstruction_builder.h:59-127`): the builder-proper knobs (the
    matching fields live with the matcher)."""

    min_track_length: int = 2
    max_track_length: int = 50
    min_num_inlier_matches: int = 30
    reconstruct_largest_connected_component: bool = False
    reconstruction_estimator_options: ReconstructionEstimatorOptions = (
        dataclasses.field(default_factory=ReconstructionEstimatorOptions)
    )


class ReconstructionBuilder:
    """Parity: `theia::ReconstructionBuilder` (`reconstruction_builder.h:131`).

    `device` is where the estimator runs: None means the CUDA card (which
    must be present); pass "cpu" to run on the CPU."""

    def __init__(self, options: ReconstructionBuilderOptions | None = None, device=None):
        self.device = default_device(device)
        self.options = options or ReconstructionBuilderOptions()
        self.reconstruction = Reconstruction()
        self.view_graph = ViewGraph()
        self.track_builder = TrackBuilder(
            self.options.min_track_length, self.options.max_track_length
        )

    # ---------------------------------------------------------------- input

    def add_image(self, image_name: str, camera_intrinsics_group: int | None = None):
        """Parity: `ReconstructionBuilder::AddImage`
        (`reconstruction_builder.h:148`)."""
        return self.reconstruction.add_view(image_name, group_id=camera_intrinsics_group)

    def add_image_with_camera_intrinsics_prior(
        self,
        image_name: str,
        prior: CameraIntrinsicsPrior,
        camera_intrinsics_group: int | None = None,
    ):
        """Parity: `AddImageWithCameraIntrinsicsPrior`
        (`reconstruction_builder.h:156`)."""
        return self.reconstruction.add_view(
            image_name, group_id=camera_intrinsics_group, prior=prior
        )

    def add_two_view_match(self, image1: str, image2: str, match: ImagePairMatch) -> bool:
        """Parity: `AddTwoViewMatch` (`reconstruction_builder.h:167`):
        reject under-matched pairs, add the view-graph edge, and feed the
        inlier correspondences to the track builder."""
        if match.twoview_info.num_verified_matches < self.options.min_num_inlier_matches:
            return False
        v1 = self.reconstruction.view_id_from_name(image1)
        v2 = self.reconstruction.view_id_from_name(image2)
        if v1 < 0 or v2 < 0:
            return False
        # ViewGraph.add_edge keys edges (min, max) and swaps the stored
        # transform itself; correspondence order is irrelevant to the
        # union-find track builder.
        self.view_graph.add_edge(v1, v2, match.twoview_info)
        if len(match.correspondences1):
            self.track_builder.add_match(
                v1, v2, match.correspondences1, match.correspondences2
            )
        return True

    def match_features(self, matcher) -> int:
        """Run a FeatureMatcher and feed every verified pair into the
        builder; returns the number of pairs added. Parity:
        `ReconstructionBuilder::ExtractAndMatchFeatures`
        (`reconstruction_builder.h:175`) minus extraction, which the
        reference delegates to Python (README.md:15-18)."""
        n = 0
        for m in matcher.match_images():
            if self.reconstruction.view_id_from_name(m.image1) < 0:
                self.add_image(m.image1)
            if self.reconstruction.view_id_from_name(m.image2) < 0:
                self.add_image(m.image2)
            if self.add_two_view_match(m.image1, m.image2, m):
                n += 1
        return n

    # --------------------------------------------------------------- output

    def build_reconstruction(self) -> list[Reconstruction]:
        """Parity: `BuildReconstruction` (`reconstruction_builder.h:186`):
        track building, then the multi-model estimation loop: each round
        extracts the estimated sub-model and retries on the leftovers."""
        opt = self.options
        self.track_builder.build_tracks(self.reconstruction)

        if opt.reconstruct_largest_connected_component:
            self.view_graph.remove_disconnected_view_pairs()

        models: list[Reconstruction] = []
        working_recon = self.reconstruction
        working_graph = self.view_graph
        while working_graph.num_edges() > 0:
            estimator = create_reconstruction_estimator(
                opt.reconstruction_estimator_options, device=self.device
            )
            summary = estimator.estimate(working_graph, working_recon)
            est_views = np.flatnonzero(working_recon.view_estimated)
            if not summary.success or len(est_views) < 2:
                break
            models.append(create_estimated_subreconstruction(working_recon))

            remaining = np.flatnonzero(~working_recon.view_estimated).tolist()
            if len(remaining) < 3:
                break
            # Re-index the leftovers into a fresh container + subgraph.
            next_recon = working_recon.get_sub_reconstruction(remaining)
            next_recon.view_estimated[:] = False
            next_recon.track_estimated[:] = False
            next_graph = ViewGraph()
            for (a, b), info in working_graph.edges.items():
                ia = next_recon.view_id_from_name(working_recon.view_names[a])
                ib = next_recon.view_id_from_name(working_recon.view_names[b])
                if ia >= 0 and ib >= 0:
                    next_graph.add_edge(ia, ib, info)
            working_recon = next_recon
            working_graph = next_graph
        return models
