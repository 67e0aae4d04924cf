"""Driver of bundle adjustment: one step is
`ba.entry.bundle_adjust_reconstruction` from the same start state.

Set-up builds the problem from the seed (the configuration's `scene`
generator) into the port's `Reconstruction`: one intrinsics group a camera,
every view and track estimated, the start state written in; the options are
the reference defaults for that many views (`set_bundle_adjustment_options`).
Each step restores the start state by `np.copyto` into the container's
extrinsics, intrinsics and points (a `harness:restore` range) and solves.
A step whose index the seed drew is copied out after it (a `harness:copy`
range) for the check; so is the last, which the container holds.

The check judges each kept solve with the reference's own Gauss-Newton
steps in f64 (`reference/ba_refine.py`), on the problem's observations:
  cost_gap   |reported final cost - the reference's cost of the returned
             state| / that cost: the projection and the cost at the
             configuration's precision, and that the reported cost is the
             returned state's (rounding of f64 against that of f32 data)
  ba_gap     |reported final cost - the reference's optimum next to the
             returned state| / that optimum: the projection, the returned
             cameras, intrinsics and points and the reported cost at once
  ba_point_gap  (the returned state's cost - the reference's optimum of the
             points alone, cameras and intrinsics held) / that cost: what
             the returned points still lack, which the state's rounding sets
  ba_excess  the returned state's cost / the ground truth's cost: below 1
             for any solve that converged, far above it for one that did not

`VARIANTS` swap the timed solve for the cell's control or a planted fault
(`--variant`, checks only): `float32`, the program's own f32 path, the
precision below the configuration's f64; `unchanged`, the start state
returned with its cost; `half`, every other observation weighted 0, the
cost taken over the rest; `altered`, one returned point moved by 1.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from pytheiasfm_tpu_torch.ba.entry import bundle_adjust_reconstruction
from pytheiasfm_tpu_torch.sfm.estimator_options import (
    ReconstructionEstimatorOptions,
    set_bundle_adjustment_options,
)
from pytheiasfm_tpu_torch.sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction

from .. import tracing
from ..reference import ba_refine
from ..reference import geometry as ref

CHECKS = ("cost_gap", "ba_gap", "ba_point_gap", "ba_excess")
FREE_SLOTS = [0, 5, 6]  # f, k1, k2 of Theia's pinhole


def build_container(scene):
    """The problem's start state in the port's container."""
    V, T = len(scene["positions"]), len(scene["points"])
    recon = Reconstruction()
    for v in range(V):
        recon.add_view(f"view_{v:04d}", group_id=None, prior=CameraIntrinsicsPrior())
    recon.intrinsics[:] = scene["start_intr"]
    recon.view_extrinsics[:] = scene["start_ext"]
    recon.view_estimated[:] = True
    recon.add_tracks_bulk(T)
    recon.points[:, :3] = scene["start_points"]
    recon.points[:, 3] = 1.0
    recon.track_estimated[:] = True
    recon.add_observations_bulk(scene["obs_view"], scene["obs_track"], scene["obs_uv"])
    return recon


def _unchanged(solve, recon):
    before = [a.copy() for a in (recon.view_extrinsics, recon.intrinsics, recon.points)]
    summary = solve()
    for dst, src in zip((recon.view_extrinsics, recon.intrinsics, recon.points), before):
        np.copyto(dst, src)
    summary.final_cost = summary.initial_cost
    return summary


def _half(solve, recon):
    saved = recon.obs_sqrt_inv_cov.copy()
    recon.obs_sqrt_inv_cov[::2] = 0.0
    try:
        return solve()
    finally:
        recon.obs_sqrt_inv_cov[:] = saved


def _altered(solve, recon):
    summary = solve()
    recon.points[0, :3] += recon.points[0, 3]
    return summary


VARIANTS = {"float32": None, "unchanged": _unchanged, "half": _half, "altered": _altered}


class Driver:
    def __init__(self, config, traffic, scene, seed, device, variant=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.variant = variant
        self.scene = scene
        self.recon = build_container(self.scene)
        self.start = [a.copy() for a in self.state()]
        self.options = set_bundle_adjustment_options(ReconstructionEstimatorOptions(),
                                                     self.recon.num_views())
        self.dtype = np.float32 if variant == "float32" else np.dtype(config["precision"]).type
        self.summaries, self.kept, self.targets = [], {}, set()
        self._obs = None

    def state(self):
        r = self.recon
        return r.view_extrinsics, r.intrinsics, r.points

    def _solve(self):
        with tracing.labelled("harness:restore"):
            for dst, src in zip(self.state(), self.start):
                np.copyto(dst, src)
        with tracing.labelled("stage:bundle adjustment"):
            def solve():
                return bundle_adjust_reconstruction(self.options, self.recon, dtype=self.dtype,
                                                    device=self.device)
            fault = VARIANTS.get(self.variant)
            return solve() if fault is None else fault(solve, self.recon)

    def warm(self):
        t = time.perf_counter()
        self._solve()
        return time.perf_counter() - t

    def prepare(self, seconds, warm_s):
        # Solves the check keeps besides the last: drawn from the seed among
        # those the window surely holds (the warm solve pays first calls).
        sure = max(1, int(seconds / warm_s))
        rng = np.random.default_rng([self.seed, 1])
        n = min(int(self.traffic["checked_solves"]) - 1, sure)
        self.targets = {int(i) for i in rng.choice(sure, size=n, replace=False)} if n > 0 else set()

    def step(self, i):
        self.summaries.append(self._solve())
        if i in self.targets:
            with tracing.labelled("harness:copy"):
                self.kept[i] = [a.copy() for a in self.state()]

    def outcome(self, steps):
        return steps, sum(not s.success for s in self.summaries[:steps])

    def counters(self, steps):
        s = self.summaries[:steps]
        return {"lm_iterations": sum(x.num_iterations for x in s),
                "pcg_steps": sum(x.num_linear_solver_iterations or 0 for x in s)}

    def notes(self):
        last = self.summaries[-1] if self.summaries else None
        return {} if last is None else {"groups": int(len(np.unique(self.recon.view_group))),
                                        "linear_solver": last.linear_solver,
                                        "size_gates": last.size_gates,
                                        "lm_iterations": last.num_iterations,
                                        "pcg_steps": last.num_linear_solver_iterations}

    def check(self, steps):
        if steps == 0:
            return []
        kept = {i: a for i, a in self.kept.items() if i < steps - 1}
        kept[steps - 1] = [a.copy() for a in self.state()]
        worst = {k: 0.0 for k in CHECKS}
        for i, state in sorted(kept.items()):
            for k, v in self.judge(state, self.summaries[i].final_cost).items():
                worst[k] = max(worst[k], v if math.isfinite(v) else math.inf)
        limits = self.config["limits"]
        return [{"name": k, "value": worst[k], "limit": limits[k]} for k in CHECKS]

    def judge(self, state, reported):
        """The numbers of one solve's returned (extrinsics, intrinsics,
        points) and reported final cost (see the module's docstring)."""
        s, dev = self.scene, self.device
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)  # noqa: E731
        if self._obs is None:
            ot = t(s["obs_track"]).long()
            order = torch.argsort(ot, stable=True)
            ov = t(s["obs_view"]).long()[order]
            self._obs = (ov, ov, ot[order], t(s["obs_uv"])[order])
            self._gt_cost = ref.cost(ref.residuals(
                t(np.concatenate([s["positions"], s["aa"]], axis=1)), t(s["intrinsics"]),
                t(s["points"]), *self._obs))
        ext, intr, pts = (t(a) for a in state)
        X = ref.euclidean(pts)
        if not all(bool(torch.isfinite(a).all()) for a in (ext, intr, X)):
            return {k: math.inf for k in CHECKS}
        start, best = ba_refine.refine(ext, intr, X, self._obs, FREE_SLOTS)
        _, points_best = ba_refine.refine_points(ext, intr, X, self._obs)
        # The reference's optimum: the lower of its two refinements (its
        # whole steps can all be refused where its points alone still move).
        best = min(best, points_best)
        return {"cost_gap": abs(reported - start) / start,
                "ba_gap": abs(reported - best) / best,
                "ba_point_gap": (start - points_best) / start,
                "ba_excess": start / self._gt_cost}
