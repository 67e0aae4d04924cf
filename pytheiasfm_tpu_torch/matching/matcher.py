"""Feature-matcher driver: all-pairs (or selected pairs) descriptor matching
with batched geometric verification.

Counterpart of the JAX package's `matching/matcher.py`
(`theia/matching/feature_matcher.{h,cc}`: pair chunking over a ThreadPool at
`feature_matcher.cc:104-133`, per-pair match -> GeometricVerification ->
database store at `:198-217`). Pairs are padded into [P, N, ...] blocks;
descriptor matching runs as one K1 kernel launch over all pairs and
calibrated verification as batched five-point RANSAC programs.

This slice runs stage 1 of verification for calibrated pairs. Stage 2 (the
guided epipolar rematch and the two-view bundle adjustment) and the
uncalibrated fundamental-matrix path raise `NotImplementedError`; they are
the follow-up items of ROADMAP.md queue 1.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..sfm.reconstruction import CameraIntrinsicsPrior
from ..sfm.reconstruction_builder import ImagePairMatch
from ..sfm.two_view import estimate_two_view_info_batch
from ..utils.log import logger
from .brute_force import match_descriptors_batch_auto
from .database import InMemoryFeaturesAndMatchesDatabase
from .options import FeatureMatcherOptions
from .types import KeypointsAndDescriptors

__all__ = ["FeatureMatcher", "BruteForceFeatureMatcher"]

_FOLLOW_UP = (
    "is not ported yet (ROADMAP.md queue 1, 'stage 2 of verification and the "
    "uncalibrated path')"
)


def _pad_pow2(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class FeatureMatcher:
    """Parity: `theia::FeatureMatcher` (`feature_matcher.h:77`).

    `device` is where matching and verification run: None means the CUDA
    card (which must be present); pass "cpu" to run on the CPU.
    """

    def __init__(
        self,
        options: FeatureMatcherOptions | None = None,
        database: InMemoryFeaturesAndMatchesDatabase | None = None,
        device=None,
    ):
        self.device = default_device(device)
        self.options = options or FeatureMatcherOptions()
        self.database = database or InMemoryFeaturesAndMatchesDatabase()
        self._image_names: list[str] = []
        self._pairs_to_match: list[tuple[str, str]] | None = None
        # Wall seconds of the last match_images: "matching" (descriptor
        # matching, ending with the match indices on the host) and
        # "verification".
        self.timings: dict[str, float] = {}

    # ------------------------------------------------------------------ input

    def add_image(
        self,
        image_name: str,
        keypoints: np.ndarray,
        descriptors: np.ndarray,
        intrinsics_prior: CameraIntrinsicsPrior | None = None,
    ):
        """Parity: `FeatureMatcher::AddImage` (feature_matcher.h:95)."""
        self.database.put_features(
            image_name,
            KeypointsAndDescriptors(
                image_name=image_name,
                keypoints=np.asarray(keypoints, np.float64),
                descriptors=np.asarray(descriptors, np.float32),
            ),
        )
        if intrinsics_prior is not None:
            self.database.put_camera_intrinsics_prior(image_name, intrinsics_prior)
        self._image_names.append(image_name)

    def set_image_pairs_to_match(self, pairs: list[tuple[str, str]]):
        """Parity: `FeatureMatcher::SetImagePairsToMatch`."""
        self._pairs_to_match = list(pairs)

    # ----------------------------------------------------------------- output

    def pairs(self) -> list[tuple[str, str]]:
        """The pairs `match_images` matches: the set ones, else all pairs."""
        if self._pairs_to_match is not None:
            return list(self._pairs_to_match)
        names = self._image_names
        return [
            (names[i], names[j])
            for i in range(len(names))
            for j in range(i + 1, len(names))
        ]

    def descriptor_batch(self, pairs):
        """The padded matcher inputs of `pairs` on the matcher's device:
        (d1, d2 [P, N, D] f32, m1, m2 [P, N] bool, kp1, kp2 [P, N, 2] host
        float64). Each image is padded once and the pair blocks gathered."""
        opt = self.options
        names = self._image_names
        feats = {n: self.database.get_features(n) for n in names}
        N = _pad_pow2(
            min(max(len(feats[n].keypoints) for n in names), opt.max_num_features)
        )
        D = max(feats[n].descriptors.shape[1] for n in names)
        index = {n: i for i, n in enumerate(names)}
        desc = np.zeros((len(names), N, D), np.float32)
        kp = np.zeros((len(names), N, 2))
        valid = np.zeros((len(names), N), bool)
        for n, i in index.items():
            f = feats[n]
            k = min(len(f.keypoints), N)
            desc[i, :k, : f.descriptors.shape[1]] = f.descriptors[:k]
            kp[i, :k] = f.keypoints[:k, :2]
            valid[i, :k] = True
        ia = np.array([index[a] for a, _ in pairs])
        ib = np.array([index[b] for _, b in pairs])
        desc_t = torch.as_tensor(desc, device=self.device)
        valid_t = torch.as_tensor(valid, device=self.device)
        ia_t = torch.as_tensor(ia, device=self.device)
        ib_t = torch.as_tensor(ib, device=self.device)
        return (
            desc_t[ia_t], desc_t[ib_t], valid_t[ia_t], valid_t[ib_t], kp[ia], kp[ib]
        )

    def match_images(self) -> list[ImagePairMatch]:
        """Parity: `FeatureMatcher::MatchImages` (feature_matcher.cc:104):
        descriptor-match every pair (one K1 launch), then geometric
        verification (batched RANSAC over the survivors)."""
        opt = self.options
        gv = opt.geometric_verification_options
        if opt.perform_geometric_verification and (
            gv.guided_matching or gv.bundle_adjustment
        ):
            raise NotImplementedError(
                "guided_matching / bundle_adjustment (stage 2 of two-view "
                "verification) " + _FOLLOW_UP + "; set both to False"
            )
        pairs = self.pairs()
        self.timings = {}
        if not pairs:
            return []

        t0 = time.perf_counter()
        d1, d2, m1, m2, kp1, kp2 = self.descriptor_batch(pairs)
        match_idx, _dist = match_descriptors_batch_auto(
            d1, d2, m1, m2, opt.lowes_ratio,
            use_lowes_ratio=opt.use_lowes_ratio,
            keep_only_symmetric=opt.keep_only_symmetric_matches,
        )
        match_idx = match_idx.cpu().numpy()
        self.timings["matching"] = time.perf_counter() - t0
        logger.info(
            "matcher: %d pairs descriptor-matched (N=%d, D=%d)",
            len(pairs), d1.shape[1], d1.shape[2],
        )

        candidates = []
        for i, (a, b) in enumerate(pairs):
            rows = np.flatnonzero(match_idx[i] >= 0)
            if len(rows) < opt.min_num_feature_matches:
                continue
            cols = match_idx[i][rows]
            candidates.append(
                dict(
                    row=i, a=a, b=b, idx1=rows, idx2=cols,
                    c1=kp1[i][rows], c2=kp2[i][cols],
                )
            )
        logger.info(
            "matcher: %d/%d pairs passed min_num_feature_matches=%d",
            len(candidates), len(pairs), opt.min_num_feature_matches,
        )
        if not candidates:
            return []

        if not opt.perform_geometric_verification:
            out = []
            for cand in candidates:
                m = ImagePairMatch(
                    image1=cand["a"],
                    image2=cand["b"],
                    correspondences1=cand["c1"],
                    correspondences2=cand["c2"],
                )
                m.twoview_info.num_verified_matches = len(cand["c1"])
                self.database.put_image_pair_match(cand["a"], cand["b"], m)
                out.append(m)
            return out

        t0 = time.perf_counter()
        out = self._verify_pairs(candidates, kp1, kp2)
        self.timings["verification"] = time.perf_counter() - t0
        return out

    def _verify_pairs(self, candidates, kp1, kp2) -> list[ImagePairMatch]:
        """Batched two-view geometric verification, stage 1.

        Parity: `FeatureMatcher::GeometricVerification`
        (feature_matcher.cc:198-217) -> `VerifyMatches`
        (two_view_match_geometric_verification.cc:114-183), RANSAC geometry
        of calibrated pairs as batched programs. RANSAC samples come from a
        generator seeded with 0 on the matcher's device.
        """
        opt = self.options
        etvi = opt.geometric_verification_options.estimate_twoview_info_options

        def prior_of(name):
            if self.database.contains_camera_intrinsics_prior(name):
                return self.database.get_camera_intrinsics_prior(name)
            return CameraIntrinsicsPrior()

        priors1 = [prior_of(c["a"]) for c in candidates]
        priors2 = [prior_of(c["b"]) for c in candidates]
        for c, p1, p2 in zip(candidates, priors1, priors2):
            if p1.focal_length is None or p2.focal_length is None:
                raise NotImplementedError(
                    f"pair ({c['a']}, {c['b']}) lacks a focal-length prior: the "
                    "uncalibrated (fundamental matrix) verification " + _FOLLOW_UP
                )

        K = _pad_pow2(max(len(c["c1"]) for c in candidates))
        P = len(candidates)
        pts1 = np.zeros((P, K, 2))
        pts2 = np.zeros((P, K, 2))
        masks = np.zeros((P, K), bool)
        for row, cand in enumerate(candidates):
            k = len(cand["c1"])
            pts1[row, :k] = cand["c1"]
            pts2[row, :k] = cand["c2"]
            masks[row, :k] = True
        generator = torch.Generator(device=self.device).manual_seed(0)
        results = estimate_two_view_info_batch(
            generator, etvi, priors1, priors2, pts1, pts2, masks,
            min_num_inlier_matches=opt.min_num_feature_matches,
            device=self.device,
        )

        out: list[ImagePairMatch] = []
        for cand, (info, inlier_idx) in zip(candidates, results):
            if info is None:
                continue
            inlier_idx = inlier_idx[inlier_idx < len(cand["c1"])]
            if len(inlier_idx) < opt.min_num_feature_matches:
                continue
            row = cand["row"]
            m = ImagePairMatch(
                image1=cand["a"],
                image2=cand["b"],
                twoview_info=info,
                correspondences1=kp1[row][cand["idx1"][inlier_idx]],
                correspondences2=kp2[row][cand["idx2"][inlier_idx]],
            )
            self.database.put_image_pair_match(cand["a"], cand["b"], m)
            out.append(m)
        return out


class BruteForceFeatureMatcher(FeatureMatcher):
    """Parity: `theia::BruteForceFeatureMatcher`
    (`brute_force_feature_matcher.h`) — the batched kernel IS brute force;
    the subclass exists for API parity."""
