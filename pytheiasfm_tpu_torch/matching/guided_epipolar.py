"""Guided epipolar matching: extra correspondences along epipolar lines.

Counterpart of the JAX package's `matching/guided_epipolar.py`
(`theia/matching/guided_epipolar_matcher.h:53`). The full [N1, N2]
point-to-line distance matrix is masked by the epipolar band and by the
features already matched, the descriptor distances are added, and the usual
top-2 ratio test picks the match. The JAX function runs on one pair and is
vmapped; here a leading pair axis is written out. Everything runs in f32,
as in the JAX function; the [N1, N2] descriptor product is a plain
`torch.matmul` (XLA's dot in the JAX package, not a Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from .streaming_matcher import _top2_lowest

__all__ = ["guided_epipolar_match", "GuidedEpipolarMatcher"]


def guided_epipolar_match(
    F,  # [P, 3, 3] fundamental matrices (image-1 -> lines in image 2)
    points1,  # [P, N1, 2] pixels
    points2,  # [P, N2, 2]
    d1,  # [P, N1, D] descriptors
    d2,  # [P, N2, D]
    mask1,  # [P, N1] bool
    mask2,  # [P, N2] bool
    already_matched1,  # [P, N1] bool: features with existing matches
    already_matched2,  # [P, N2] bool
    max_epipolar_distance: float = 2.0,
    lowes_ratio: float = 0.8,
    use_lowes_ratio: bool = True,
):
    """Returns match_idx [P, N1] int32 into points2, or -1. Only features
    without a match participate (guided_epipolar_matcher.h behaviour).

    Ties: among equal descriptor distances the lowest index wins and the
    second best masks only that slot, as `jax.lax.top_k` orders them.
    """
    f32 = torch.float32
    # The thresholds in f32, as the JAX function receives them.
    max_dist = torch.tensor(max_epipolar_distance, dtype=f32, device=F.device)
    ratio = torch.tensor(lowes_ratio, dtype=f32, device=F.device)
    h1 = torch.cat([points1, torch.ones_like(points1[..., :1])], dim=-1).to(f32)
    h2 = torch.cat([points2, torch.ones_like(points2[..., :1])], dim=-1).to(f32)
    lines = h1 @ F.to(f32).mT  # [P, N1, 3] epipolar lines in image 2
    # Point-line distance |l . x| / ||l[:2]||.
    num = torch.abs(lines @ h2.mT)  # [P, N1, N2]
    den = torch.linalg.norm(lines[..., :2], dim=-1, keepdim=True)
    in_band = num / torch.clamp(den, min=1e-12) <= max_dist
    del num

    d1 = d1.to(f32)
    d2 = d2.to(f32)
    sq1 = torch.sum(d1**2, dim=-1)
    sq2 = torch.sum(d2**2, dim=-1)
    desc_dist = sq1[..., :, None] + sq2[..., None, :] - 2.0 * (d1 @ d2.mT)

    valid = (
        in_band
        & (mask1 & ~already_matched1)[..., :, None]
        & (mask2 & ~already_matched2)[..., None, :]
    )
    del in_band
    desc_dist = torch.where(valid, desc_dist, torch.inf)
    del valid

    best, second, arg = _top2_lowest(desc_dist, dim=-1)
    ok = torch.isfinite(best)
    if use_lowes_ratio:
        ok &= best < ratio**2 * second
    return torch.where(ok, arg, -1).to(torch.int32)


class GuidedEpipolarMatcher:
    """Host shim with the reference's GetMatches-style API. `device` is where
    the match runs: None means the CUDA card; pass "cpu" for the CPU."""

    def __init__(
        self, max_epipolar_distance: float = 2.0, lowes_ratio: float = 0.8, device=None
    ):
        self.max_epipolar_distance = max_epipolar_distance
        self.lowes_ratio = lowes_ratio
        self.device = default_device(device)

    def get_matches(self, F, feats1, feats2, existing_matches):
        """feats1/feats2: KeypointsAndDescriptors; existing_matches: list of
        (i, j). Returns the augmented match list."""
        n1 = len(feats1.keypoints)
        n2 = len(feats2.keypoints)
        am1 = np.zeros(n1, bool)
        am2 = np.zeros(n2, bool)
        for i, j in existing_matches:
            am1[i] = True
            am2[j] = True

        def dev(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)[None]

        f32 = torch.float32
        idx = guided_epipolar_match(
            dev(F, f32),
            dev(feats1.keypoints[:, :2], f32),
            dev(feats2.keypoints[:, :2], f32),
            dev(feats1.descriptors, f32),
            dev(feats2.descriptors, f32),
            torch.ones((1, n1), dtype=torch.bool, device=self.device),
            torch.ones((1, n2), dtype=torch.bool, device=self.device),
            dev(am1),
            dev(am2),
            self.max_epipolar_distance,
            self.lowes_ratio,
        )[0].cpu().numpy()
        out = list(existing_matches)
        for i in np.flatnonzero(idx >= 0):
            out.append((int(i), int(idx[i])))
        return out
