"""Feature-matcher driver: all-pairs (or selected pairs) descriptor matching
with batched geometric verification.

Counterpart of the JAX package's `matching/matcher.py`
(`theia/matching/feature_matcher.{h,cc}`: pair chunking over a ThreadPool at
`feature_matcher.cc:104-133`, per-pair match -> GeometricVerification ->
database store at `:198-217`). Pairs are padded into [P, N, ...] blocks;
descriptor matching runs as one K1 kernel launch over all pairs, and
calibrated verification as batched programs: stage 1, five-point RANSAC;
stage 2, the guided epipolar rematch (`guided_matching`) and the
triangulation gate + two-view bundle adjustment (`bundle_adjustment`, on by
default).

Pairs without a focal-length prior on both sides (the uncalibrated
fundamental-matrix path) raise `NotImplementedError`: the JAX reference of
that path fails (ROADMAP.md, "Faults found").
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..sfm.reconstruction import CameraIntrinsicsPrior
from ..sfm.reconstruction_builder import ImagePairMatch
from ..sfm.two_view import estimate_two_view_info_batch
from ..sfm.two_view_match_geometric_verification import (
    _prior_K,
    fundamental_from_two_view_info,
    refine_relative_pose_batch,
)
from ..utils.log import logger
from .brute_force import match_descriptors_batch_auto
from .database import InMemoryFeaturesAndMatchesDatabase
from .guided_epipolar import guided_epipolar_match
from .options import FeatureMatcherOptions
from .types import KeypointsAndDescriptors

__all__ = ["FeatureMatcher", "BruteForceFeatureMatcher"]

_UNCALIBRATED = (
    "the uncalibrated (fundamental matrix) verification is not ported yet: its "
    "JAX reference, sfm/two_view.estimate_two_view_info, fails on such pairs "
    "(ROADMAP.md, 'Faults found')"
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
        # matching, ending with the match indices on the host),
        # "verification" (both stages) and "refinement" (stage 2 alone, part
        # of "verification").
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
        verification (batched RANSAC over the survivors, then stage 2)."""
        opt = self.options
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
        padded = dict(d1=d1, d2=d2, m1=m1, m2=m2, kp1=kp1, kp2=kp2)
        out = self._verify_pairs(candidates, padded)
        self.timings["verification"] = time.perf_counter() - t0
        return out

    def _verify_pairs(self, candidates, padded) -> list[ImagePairMatch]:
        """Batched two-view geometric verification.

        Parity: `FeatureMatcher::GeometricVerification`
        (feature_matcher.cc:198-217) -> `VerifyMatches`
        (two_view_match_geometric_verification.cc:114-183). Stage 1 (RANSAC
        geometry of calibrated pairs) runs as batched programs, with samples
        from a generator seeded with 0 on the matcher's device; stage 2
        (guided rematch, triangulation gate, two-view BA) as batched programs
        over the survivors. `padded` holds the matcher inputs of all pairs:
        d1, d2, m1, m2 on the device and kp1, kp2 on the host.
        """
        opt = self.options
        gv = opt.geometric_verification_options
        etvi = gv.estimate_twoview_info_options

        def prior_of(name):
            if self.database.contains_camera_intrinsics_prior(name):
                return self.database.get_camera_intrinsics_prior(name)
            return CameraIntrinsicsPrior()

        priors1 = [prior_of(c["a"]) for c in candidates]
        priors2 = [prior_of(c["b"]) for c in candidates]
        for c, p1, p2 in zip(candidates, priors1, priors2):
            if p1.focal_length is None or p2.focal_length is None:
                raise NotImplementedError(
                    f"pair ({c['a']}, {c['b']}) lacks a focal-length prior: " + _UNCALIBRATED
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

        # survivors: (cand, prior1, prior2, info, idx1, idx2) with idx1/idx2
        # the per-image feature indices of the inlier matches.
        survivors = []
        for cand, p1, p2, (info, inlier_idx) in zip(candidates, priors1, priors2, results):
            if info is None:
                continue
            inlier_idx = inlier_idx[inlier_idx < len(cand["c1"])]
            survivors.append(
                (cand, p1, p2, info, cand["idx1"][inlier_idx], cand["idx2"][inlier_idx])
            )

        if survivors and (gv.guided_matching or gv.bundle_adjustment):
            t0 = time.perf_counter()
            survivors = self._refine_survivors(survivors, padded)
            self.timings["refinement"] = time.perf_counter() - t0

        out: list[ImagePairMatch] = []
        for cand, _p1, _p2, info, idx1, idx2 in survivors:
            if len(idx1) < opt.min_num_feature_matches:
                continue
            row = cand["row"]
            m = ImagePairMatch(
                image1=cand["a"],
                image2=cand["b"],
                twoview_info=info,
                correspondences1=padded["kp1"][row][idx1],
                correspondences2=padded["kp2"][row][idx2],
            )
            self.database.put_image_pair_match(cand["a"], cand["b"], m)
            out.append(m)
        return out

    def _refine_survivors(self, survivors, padded, guided_chunk: int = 4):
        """Stage 2 of verification, batched over pairs: guided epipolar
        rematch (two_view_match_geometric_verification.cc:157-168), then
        triangulation gate + two-view BA + final reprojection gate
        (`:170-180` and `BundleAdjustRelativePose`). Updates each survivor's
        `TwoViewInfo` in place (rotation, unit position, verified count), as
        the JAX package does."""
        gv = self.options.geometric_verification_options
        dev = self.device
        f32 = torch.float32
        P = len(survivors)
        N = padded["kp1"].shape[1]
        Ks1 = np.stack([_prior_K(s[1]) for s in survivors])
        Ks2 = np.stack([_prior_K(s[2]) for s in survivors])
        # Focal lengths actually used for normalization (priors or recovered).
        f1s = np.array([s[3].focal_length_1 or 1.0 for s in survivors])
        f2s = np.array([s[3].focal_length_2 or 1.0 for s in survivors])

        if gv.guided_matching:
            rows = np.array([s[0]["row"] for s in survivors])
            F = fundamental_from_two_view_info(
                torch.as_tensor(np.stack([s[3].rotation_2 for s in survivors])),
                torch.as_tensor(np.stack([s[3].position_2 for s in survivors])),
                torch.as_tensor(Ks1),
                torch.as_tensor(Ks2),
            )
            already1 = np.zeros((P, N), bool)
            already2 = np.zeros((P, N), bool)
            for i, s in enumerate(survivors):
                already1[i, s[4]] = True
                already2[i, s[5]] = True
            guided_idx = []
            for s0 in range(0, P, guided_chunk):
                sl = slice(s0, min(s0 + guided_chunk, P))
                r = rows[sl]
                rd = torch.as_tensor(r, device=dev)
                guided_idx.append(
                    guided_epipolar_match(
                        F[sl].to(device=dev, dtype=f32),
                        torch.as_tensor(padded["kp1"][r], dtype=f32, device=dev),
                        torch.as_tensor(padded["kp2"][r], dtype=f32, device=dev),
                        padded["d1"][rd],
                        padded["d2"][rd],
                        padded["m1"][rd],
                        padded["m2"][rd],
                        torch.as_tensor(already1[sl], device=dev),
                        torch.as_tensor(already2[sl], device=dev),
                        gv.guided_matching_max_distance_pixels,
                        gv.guided_matching_lowes_ratio,
                    )
                )
            guided_idx = torch.cat(guided_idx).cpu().numpy()
            new_survivors = []
            for i, (cand, p1, p2, info, idx1, idx2) in enumerate(survivors):
                extra1 = np.flatnonzero(guided_idx[i] >= 0)
                extra2 = guided_idx[i][extra1]
                new_survivors.append(
                    (cand, p1, p2, info, np.concatenate([idx1, extra1]),
                     np.concatenate([idx2, extra2]))
                )
            survivors = new_survivors

        if not gv.bundle_adjustment:
            return survivors

        K = _pad_pow2(max(len(s[4]) for s in survivors), floor=32)
        n1 = np.zeros((P, K, 2), np.float32)
        n2 = np.zeros((P, K, 2), np.float32)
        mask = np.zeros((P, K), bool)
        aa0 = np.zeros((P, 3), np.float32)
        pos0 = np.zeros((P, 3), np.float32)
        for i, (cand, _p1, _p2, info, idx1, idx2) in enumerate(survivors):
            row = cand["row"]
            k = len(idx1)
            n1[i, :k] = (padded["kp1"][row][idx1] - Ks1[i][:2, 2]) / f1s[i]
            n2[i, :k] = (padded["kp2"][row][idx2] - Ks2[i][:2, 2]) / f2s[i]
            mask[i, :k] = True
            aa0[i] = info.rotation_2
            pos0[i] = info.position_2
        geo_f = np.sqrt(f1s * f2s)[:, None].astype(np.float32)

        def to_dev(x):
            return torch.as_tensor(x, device=dev)

        aa, pos, keep = refine_relative_pose_batch(
            to_dev(aa0),
            to_dev(pos0),
            to_dev(n1),
            to_dev(n2),
            to_dev(mask),
            to_dev(gv.triangulation_max_reprojection_error / geo_f),
            gv.min_triangulation_angle_degrees,
            to_dev(gv.final_max_reprojection_error / geo_f),
        )
        aa = aa.cpu().numpy().astype(np.float64)
        pos = pos.cpu().numpy().astype(np.float64)
        keep = keep.cpu().numpy()
        out = []
        for i, (cand, p1, p2, info, idx1, idx2) in enumerate(survivors):
            sel = np.flatnonzero(keep[i][: len(idx1)])
            nrm = np.linalg.norm(pos[i])
            info.rotation_2 = aa[i]
            info.position_2 = pos[i] / (nrm if nrm > 0 else 1.0)
            info.num_verified_matches = len(sel)
            out.append((cand, p1, p2, info, idx1[sel], idx2[sel]))
        return out


class BruteForceFeatureMatcher(FeatureMatcher):
    """Parity: `theia::BruteForceFeatureMatcher`
    (`brute_force_feature_matcher.h`) — the batched kernel IS brute force;
    the subclass exists for API parity."""
