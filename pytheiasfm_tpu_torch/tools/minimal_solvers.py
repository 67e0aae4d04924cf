"""The remaining minimal solvers and their estimators at localization scale.

    python -m pytheiasfm_tpu_torch.tools.minimal_solvers [--device cpu]
        [--samples 16384] [--only NAME ...]

`build_problems` makes the six estimators' problems from a seed:
- P4Pf and P4Pfr: the 553 problems of `tools/localization.build_problems`
  (443-565 rows, 30% outliers) as principal-point-centred pixels (focal
  length 1000); for P4Pfr distorted by the division model with
  `P4PFR_K1` (normalized units, inside the estimator's bounds); the
  threshold 4 px, resolution-scaled, squared;
- gDLS and UPnP: 138 generalized cameras, each 4 neighbouring views of the
  same scene (by their angle on the ring), their rays mapped into a rig
  frame by a random rigid transform (similarity: also scaled by
  `RIG_SCALE`), against the views' world points (30% outliers); the
  threshold the views' squared normalized one, as a squared sine;
- the dominant plane: 553 problems of 500 points, 60% on a random plane
  with 0.01 noise, the rest lifted 1-4 units off it (the JAX test's
  construction); threshold 0.05^2;
- the radial homography: 553 problems of 64 correspondences
  (`tests/test_robust_estimators_extra.py`'s construction: H = I + N(0,
  0.1), l1 = -0.2, l2 = -0.4), 10 of them (15%) moved 0.2-0.5 off;
  threshold 0.01^2.

`run_estimator` solves every problem of one estimator in one batched call
at `ITERATIONS[name]` hypotheses, and `estimator_errors` reads the result
against ground truth; `pool` joins the errors of `DRAWS[name]` runs. `minimal_samples` makes exact minimal samples of each
of the thirteen solvers of `SOLVERS`, `solve` runs one on them and
`recovered` says which recover their ground truth. Run as a script it times
each estimator (first and warm) and each solver, with peak memory, on the
card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import default_device
from ..ops import focal_radial, generalized_pose, orthographic, partial_rotation
from ..ops import radial_homography
from ..ransac import engine, estimators
from . import localization

__all__ = [
    "DRAWS",
    "ESTIMATORS",
    "ITERATIONS",
    "SOLVERS",
    "build_problems",
    "estimator_errors",
    "agreement",
    "minimal_samples",
    "pool",
    "recovered",
    "run_estimator",
    "solutions",
    "solve",
    "summarize",
]

P4PFR_K1 = -0.05
RIG_VIEWS = 4
RIG_SCALE = 2.5
PLANE_POINTS, PLANE_SHARE = 500, 0.6
HOMOGRAPHY_POINTS, HOMOGRAPHY_OUTLIERS = 64, 10
L1, L2 = -0.2, -0.4
ESTIMATORS = ("p4pf", "p4pfr", "similarity", "rigid", "plane", "radial_homography")
# Hypotheses a problem, one batched call an estimator.
ITERATIONS = {"p4pf": 1000, "p4pfr": 256, "similarity": 256, "rigid": 256, "plane": 1000,
              "radial_homography": 64}
# Inliers a problem must keep to count as solved.
MIN_INLIERS = {"p4pf": 30, "p4pfr": 30, "similarity": 30, "rigid": 30,
               "plane": int(0.5 * PLANE_POINTS), "radial_homography": HOMOGRAPHY_POINTS - 20}
# Runs (generator seeds 0..n-1; the JAX package's PRNG keys 0..n-1) whose
# errors an estimator's medians pool: the generalized cameras are 138
# problems, over which one run's median moves by a third with the draws
# (gDLS's scale 0.68-0.90% over five seeds on an H100).
DRAWS = {"similarity": 5, "rigid": 5}


def _rotation(rng, scale):
    aa = rng.normal(size=3)
    aa = aa / np.linalg.norm(aa) * scale
    th = np.linalg.norm(aa)
    K = np.array([[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def distort(points, k1):
    """Normalized undistorted points [.., 2] -> distorted by the division
    model (undistorted = distorted / (1 + k1 r_d^2)), exactly."""
    ru2 = np.sum(points**2, axis=-1, keepdims=True)
    safe = np.where(ru2 < 1e-24, 1.0, ru2)
    scale = np.where(ru2 < 1e-24, 1.0, (1 - np.sqrt(1 - 4 * k1 * safe)) / (2 * k1 * safe))
    return points * scale


def _radial_homography_problem(rng, n, n_out):
    H = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    x1 = rng.uniform(-0.6, 0.6, size=(n, 2))
    r2 = np.sum(x1**2, axis=-1, keepdims=True)
    u2 = (H @ np.concatenate([x1, 1.0 + L1 * r2], axis=-1).T).T
    xy, w = u2[:, :2], u2[:, 2:3]
    a = np.sum(xy**2, axis=-1, keepdims=True) * L2
    x2 = xy / ((w + np.sqrt(np.maximum(w**2 - 4 * a, 1e-12))) / 2.0)
    x2[:n_out] += rng.uniform(0.2, 0.5, size=(n_out, 2)) * rng.choice([-1, 1], size=(n_out, 2))
    return x1, x2, H


def build_problems(V: int = 553, T: int = 50_000, seed: int = 0):
    """name -> dict of host arrays (inputs, `mask`, `thresh`, ground truth)
    for each of ESTIMATORS."""
    loc = localization.build_problems(V, T, seed)
    f = loc["focal_length"]
    out = {}
    common = dict(world=loc["world"], mask=loc["mask"], rotation=loc["rotation"],
                  position=loc["position"], focal=np.full(V, f))
    out["p4pf"] = dict(common, feature=loc["feature"] * f, thresh=loc["thresh"] * f**2)
    out["p4pfr"] = dict(common, feature=distort(loc["feature"], P4PFR_K1) * f,
                        thresh=loc["thresh"] * f**2, k1=np.full(V, P4PFR_K1))

    # Rigs of neighbouring views on the ring, mapped into a rig frame.
    angle = np.arctan2(loc["position"][:, 1], loc["position"][:, 0])
    rigs = np.argsort(angle, kind="stable")[: (V // RIG_VIEWS) * RIG_VIEWS].reshape(-1, RIG_VIEWS)
    R_v, c_v = loc["rotation"][rigs], loc["position"][rigs]  # [G, 4, 3, 3], [G, 4, 3]
    bearing = np.concatenate([loc["feature"][rigs], np.ones(loc["mask"][rigs].shape + (1,))], -1)
    dirs = np.einsum("gvji,gvnj->gvni", R_v, bearing)  # R_v^T b, world frame
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c_v[:, :, None, :], dirs.shape)
    G, N = rigs.shape[0], RIG_VIEWS * loc["mask"].shape[1]
    rng = np.random.default_rng([seed, 16])
    for name, scale in (("similarity", RIG_SCALE), ("rigid", 1.0)):
        R_g = np.stack([_rotation(rng, rng.uniform(0.2, 1.5)) for _ in range(G)])
        t_g = rng.normal(size=(G, 3)) * 5.0
        o = scale * np.einsum("gij,gvnj->gvni", R_g, origins) + t_g[:, None, None]
        d = np.einsum("gij,gvnj->gvni", R_g, dirs)
        out[name] = dict(ray_origin=o.reshape(G, N, 3), ray_direction=d.reshape(G, N, 3),
                         world=loc["world"][rigs].reshape(G, N, 3),
                         mask=loc["mask"][rigs].reshape(G, N), thresh=loc["thresh"][rigs[:, 0]],
                         rotation=R_g, translation=t_g, scale=np.full(G, scale))

    # Planes.
    n_in = int(PLANE_SHARE * PLANE_POINTS)
    normals = rng.normal(size=(V, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    basis = np.stack([np.linalg.svd(n[None])[2][1:] for n in normals])  # [V, 2, 3]
    p0 = rng.uniform(-5, 5, size=(V, 3))
    pts = p0[:, None] + np.einsum("vnk,vkj->vnj", rng.uniform(-5, 5, (V, PLANE_POINTS, 2)), basis)
    pts += rng.normal(size=pts.shape) * 0.01
    pts[:, n_in:] += normals[:, None] * rng.uniform(1, 4, size=(V, PLANE_POINTS - n_in, 1))
    out["plane"] = dict(points=pts, mask=np.ones(pts.shape[:2], bool),
                        thresh=np.full(V, 0.05**2), normal=normals)

    # Radial homographies.
    x1, x2, H = zip(*(_radial_homography_problem(rng, HOMOGRAPHY_POINTS, HOMOGRAPHY_OUTLIERS)
                      for _ in range(V)))
    out["radial_homography"] = dict(points1=np.stack(x1), points2=np.stack(x2),
                                    mask=np.ones((V, HOMOGRAPHY_POINTS), bool),
                                    thresh=np.full(V, 0.01**2), H=np.stack(H),
                                    l1=np.full(V, L1), l2=np.full(V, L2))
    return out


# name -> (estimate function, its Estimator at the function's default
# bounds, data type, the problem's arrays in the data type's order).
_ESTIMATOR_TABLE = {
    "p4pf": (estimators.estimate_uncalibrated_absolute_pose,
             estimators.UNCALIBRATED_ABSOLUTE_POSE_ESTIMATOR, estimators.Corr2D3D,
             ("feature", "world")),
    "p4pfr": (estimators.estimate_radial_dist_uncalibrated_absolute_pose,
              estimators.RADIAL_DIST_UNCALIBRATED_ABSOLUTE_POSE_ESTIMATOR, estimators.Corr2D3D,
              ("feature", "world")),
    "similarity": (estimators.estimate_similarity_transformation_2d_3d,
                   estimators.SIMILARITY_2D_3D_ESTIMATOR, estimators.GeneralizedCorr2D3D,
                   ("ray_origin", "ray_direction", "world")),
    "rigid": (estimators.estimate_rigid_transformation_2d_3d,
              estimators.RIGID_2D_3D_ESTIMATOR, estimators.GeneralizedCorr2D3D,
              ("ray_origin", "ray_direction", "world")),
    "plane": (estimators.estimate_dominant_plane_from_points,
              estimators.DOMINANT_PLANE_ESTIMATOR, estimators.PlaneData, ("points",)),
    "radial_homography": (estimators.estimate_radial_distortion_homography,
                          estimators.RADIAL_DISTORTION_HOMOGRAPHY_ESTIMATOR,
                          estimators.TwoViewData, ("points1", "points2")),
}


def estimator_inputs(name, prob):
    """The estimate function of `name` and its data arrays, in its order."""
    fn, _, _, keys = _ESTIMATOR_TABLE[name]
    return fn, tuple(prob[k] for k in keys)


def estimator_and_data(name, prob, device, dtype=torch.float32):
    """(engine.Estimator, data, mask, thresh) of estimator `name` on its
    problems `prob`, as tensors on `device` (for `engine.score_samples`)."""
    t = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt,  # noqa: E731
                                            device=device)
    _, est, data_type, keys = _ESTIMATOR_TABLE[name]
    return (est, data_type(*(t(prob[k]) for k in keys)), t(prob["mask"], torch.bool),
            t(prob["thresh"]))


def run_estimator(problems, name, generator, device, dtype=torch.float32, iterations=None,
                  rows=None):
    """Every problem of estimator `name` (or the problems `rows`) in one
    batched call at `iterations` (default ITERATIONS[name]) hypotheses.
    Returns (model, summary)."""
    prob = problems[name]
    sel = slice(None) if rows is None else rows
    fn, arrays = estimator_inputs(name, prob)
    n = ITERATIONS[name] if iterations is None else iterations
    params = engine.RansacParameters(max_iterations=n, min_iterations=n)

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x[sel]), dtype=dt, device=device)

    return fn(generator, *(t(a) for a in arrays), params, mask=t(prob["mask"], torch.bool),
              error_thresh=t(prob["thresh"]))


def _angle_deg(R1, R2):
    """Angles between rotations [P, 3, 3] in degrees (atan2 of sin, cos)."""
    rel = np.einsum("pij,pkj->pik", np.asarray(R1, np.float64), R2)
    sin = 0.5 * np.linalg.norm(np.stack([rel[:, 2, 1] - rel[:, 1, 2], rel[:, 0, 2] - rel[:, 2, 0],
                                         rel[:, 1, 0] - rel[:, 0, 1]], -1), axis=-1)
    cos = 0.5 * (np.trace(rel, axis1=1, axis2=2) - 1)
    return np.degrees(np.arctan2(sin, cos))


def estimator_errors(name, model, num_inliers, problems, rows=None):
    """Per-problem errors of a result against ground truth (host arrays):
    dict of arrays [P] ("solved" the problems with MIN_INLIERS inliers or
    more)."""
    prob = problems[name]
    sel = slice(None) if rows is None else rows
    g = lambda key: np.asarray(prob[key])[sel]  # noqa: E731
    m = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
         for k, v in model._asdict().items()}
    err = dict(solved=np.asarray(num_inliers) >= MIN_INLIERS[name])
    if name in ("p4pf", "p4pfr"):
        err["focal"] = np.abs(m["focal_length"] / g("focal") - 1)
        err["rotation_deg"] = _angle_deg(m["rotation"], g("rotation"))
        if name == "p4pf":
            err["position"] = np.linalg.norm(m["position"] - g("position"), axis=-1)
        else:
            err["k1"] = np.abs(m["radial_distortion"] - g("k1"))
    elif name in ("similarity", "rigid"):
        err["rotation_deg"] = _angle_deg(m["rotation"], g("rotation"))
        err["translation"] = np.linalg.norm(m["translation"] - g("translation"), axis=-1)
        if name == "similarity":
            err["scale"] = np.abs(m["scale"] / g("scale") - 1)
    elif name == "plane":
        err["normal_deg"] = np.degrees(np.arccos(np.clip(np.abs(np.sum(
            m["unit_normal"] * g("normal"), -1)), 0, 1)))
    else:
        err["l1"] = np.abs(m["l1"] - g("l1"))
        err["l2"] = np.abs(m["l2"] - g("l2"))
    return err


def pool(errs):
    """The error dicts of several runs on the same problems as one."""
    return {k: np.concatenate([e[k] for e in errs]) for k in errs[0]}


def summarize(err):
    """Medians of the error arrays and the share solved."""
    out = {k: float(np.median(v)) for k, v in err.items() if k != "solved"}
    out["solved"] = float(np.mean(err["solved"]))
    return out


# name -> (module, function, keyword arguments, sample size): the solvers
# held on exact minimal samples; the partial-rotation solvers take the
# axis `AXIS` first.
SOLVERS = {
    "p4pf": (focal_radial, "four_point_pose_and_focal_length", {}, 4),
    "p5pfr1": (focal_radial, "five_point_focal_length_radial_distortion", {}, 5),
    "p5pfr2": (focal_radial, "five_point_focal_length_radial_distortion",
               {"num_radial_distortion_params": 2}, 5),
    "p4pfr": (focal_radial, "four_point_pose_focal_length_radial_distortion", {}, 4),
    "radial_homography": (radial_homography, "six_point_radial_distortion_homography", {}, 6),
    "upnp": (generalized_pose, "upnp", {}, 4),
    "mlpnp": (generalized_pose, "mlpnp", {}, 6),
    "gdls": (generalized_pose, "gdls_similarity_transform", {}, 4),
    "orthographic": (orthographic, "planar_uncalibrated_orthographic_pose", {}, 4),
    "two_point_partial": (partial_rotation, "two_point_pose_partial_rotation", {}, 2),
    "three_point_partial": (partial_rotation, "three_point_relative_pose_partial_rotation",
                            {}, 3),
    "four_point_partial": (partial_rotation, "four_point_relative_pose_partial_rotation", {}, 4),
    "sim_partial": (partial_rotation, "sim_transform_partial_rotation", {}, 5),
}
AXIS = np.array([0.2, 1.0, -0.3]) / np.linalg.norm([0.2, 1.0, -0.3])


def _axis_rot(axis, angle):
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle)[:, None, None] * K
            + (1 - np.cos(angle))[:, None, None] * (K @ K))


def minimal_samples(name, count: int = 16384, seed: int = 0):
    """Exact minimal samples of solver `name`: (inputs, ground truth), the
    inputs numpy arrays [count, ...] in the solver's argument order (the
    axis [3] first for the partial-rotation solvers)."""
    rng = np.random.default_rng([seed, list(SOLVERS).index(name)])
    n = SOLVERS[name][3]
    R = np.stack([_rotation(rng, a) for a in rng.uniform(0.05, 1.2, count)])
    t = rng.normal(size=(count, 3)) * 0.5 + np.array([0.0, 0.0, 1.0])
    X = rng.uniform(-1.5, 1.5, (count, n, 3)) + np.array([0.0, 0.0, 5.0])
    Xc = np.einsum("bij,bnj->bni", R, X) + t[:, None]
    if name in SOLVERS and name.startswith(("p4p", "p5p")):
        f = rng.uniform(500.0, 3000.0, count)
        k = np.zeros(count) if name == "p4pf" else rng.uniform(-0.3, -0.02, count)
        uv = distort(Xc[..., :2] / Xc[..., 2:], k[:, None, None]) if name != "p4pf" else (
            Xc[..., :2] / Xc[..., 2:])
        return (uv * f[:, None, None], X), dict(rotation=R, translation=t, focal=f, k1=k)
    if name == "radial_homography":
        l1, l2 = rng.uniform(-1.0, -0.1, (2, count))
        H = R + rng.normal(size=(count, 3, 3)) * 0.05
        u1 = rng.uniform(-0.4, 0.4, (count, n, 2))
        u2h = np.einsum("bij,bnj->bni", H, np.concatenate([u1, np.ones_like(u1[..., :1])], -1))
        p1 = distort(u1, l1[:, None, None])
        p2 = distort(u2h[..., :2] / u2h[..., 2:], l2[:, None, None])
        return (p1, p2), dict(l1=l1, l2=l2)
    if name in ("upnp", "gdls"):
        s = np.ones(count) if name == "upnp" else rng.uniform(0.5, 3.0, count)
        o = rng.uniform(-0.4, 0.4, (count, n, 3))
        d = s[:, None, None] * np.einsum("bij,bnj->bni", R, X) + t[:, None] - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (o, d, X), dict(rotation=R, translation=t, scale=s)
    if name == "mlpnp":
        cov = np.broadcast_to(np.eye(3), (count, n, 3, 3))
        return (Xc[..., :2] / Xc[..., 2:], cov, X), dict(rotation=R, translation=t)
    if name == "orthographic":
        m = rng.uniform(50.0, 1000.0, count)
        Xp = np.concatenate([X[..., :2] - np.array([0.0, 0.0]), np.zeros_like(X[..., :1])], -1)
        pix = m[:, None, None] * np.einsum("bij,bnj->bni", R[:, :2], Xp) + rng.normal(
            size=(count, 1, 2)) * 20
        return (pix, Xp), dict(rotation=R, magnification=m)
    angle = rng.uniform(-2.5, 2.5, count)
    Ra = _axis_rot(AXIS, angle)
    if name == "two_point_partial":
        return (AXIS, X, np.einsum("bij,bnj->bni", Ra, X) + t[:, None]), dict(
            rotation=Ra, translation=t)
    if name == "three_point_partial":
        tu = t / np.linalg.norm(t, axis=-1, keepdims=True)
        return (AXIS, X, np.einsum("bij,bnj->bni", Ra, X) + tu[:, None]), dict(
            rotation=Ra, translation=tu)
    s = np.ones(count) if name == "four_point_partial" else rng.uniform(0.5, 3.0, count)
    o1, o2 = rng.uniform(-0.2, 0.2, (2, count, n, 3))
    d2 = s[:, None, None] * np.einsum("bij,bnj->bni", Ra, X) + t[:, None] - o2
    return (AXIS, X - o1, o1, d2, o2), dict(rotation=Ra, translation=t, scale=s)


def solve(name, inputs, device, dtype=torch.float32):
    """Solver `name` of the port on the inputs: its outputs as host arrays."""
    module, fn, kw, _ = SOLVERS[name]
    args = [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
            for a in inputs]
    out = getattr(module, fn)(*args, **kw)
    return tuple(o.detach().cpu().numpy() for o in out)


def solutions(name, outputs):
    """The outputs as solution rows [count, S, d] and valid [count, S], in
    one layout for every solver (single-solution solvers: S = 1, all valid
    where finite)."""
    o = [np.asarray(x, np.float64) for x in outputs]
    flat = lambda x, S: x.reshape(x.shape[0], S, -1)  # noqa: E731
    if name in ("p4pf", "p5pfr1", "p5pfr2"):
        parts, valid = [flat(o[0], 4), o[1][..., None]], outputs[-1]
        if name != "p4pf":
            parts.append(o[2])
    elif name == "p4pfr":
        parts, valid = [flat(o[0], 4), o[1], o[2][..., None], o[3][..., None]], outputs[-1]
    elif name == "radial_homography":
        H = o[0] / np.linalg.norm(o[0], axis=(-1, -2), keepdims=True)
        big = np.take_along_axis(flat(H, 4), np.argmax(np.abs(flat(H, 4)), -1)[..., None], -1)
        parts, valid = [flat(H, 4) * np.sign(big), o[1][..., None], o[2][..., None]], outputs[-1]
    elif name in ("upnp", "mlpnp", "gdls"):
        parts = [flat(o[0], 1), flat(o[1], 1)] + ([flat(o[2], 1)] if name == "gdls" else [])
        valid = np.isfinite(o[-1])[:, None]
    elif name == "orthographic":
        parts, valid = [flat(o[0], 2), o[1], np.repeat(o[2][:, None, None], 2, 1)], outputs[-1]
    else:
        S = o[0].shape[1]
        t = o[1]
        if name == "three_point_partial":
            # The null vector's sign is the SVD's.
            t = t * np.where(t[..., 2:3] < 0, -1.0, 1.0)
        parts = [flat(o[0], S), t] + ([o[2][..., None]] if name == "sim_partial" else [])
        valid = outputs[-1]
    return np.concatenate(parts, axis=-1), np.asarray(valid, bool)


def recovered(name, outputs, gt, tol=1e-2):
    """[count] whether a valid solution meets the ground truth: focal
    length and distortion within `tol` (relative, absolute), rotation and
    translation within `tol` (Frobenius, Euclidean), the radial
    homography's l1, l2 within 0.05 (the JAX test's bar)."""
    o = [np.asarray(x, np.float64) for x in outputs]
    valid = np.asarray(outputs[-1], bool)
    if name in ("p4pf", "p5pfr1", "p5pfr2", "p4pfr"):
        if name == "p4pfr":
            R, f, k = o[0], o[3], o[2]
        else:
            f = o[1]
            R = o[0][..., :3] / np.stack([f, f, np.ones_like(f)], -1)[..., None]
            k = o[2][..., 0] if name != "p4pf" else np.zeros_like(f)
        ok = ((np.abs(f / gt["focal"][:, None] - 1) < tol)
              & (np.linalg.norm(R - gt["rotation"][:, None], axis=(-1, -2)) < tol)
              & (np.abs(k - gt["k1"][:, None]) < tol))
    elif name == "radial_homography":
        ok = (np.abs(o[1] - gt["l1"][:, None]) < 0.05) & (np.abs(o[2] - gt["l2"][:, None]) < 0.05)
    elif name in ("upnp", "mlpnp", "gdls"):
        valid = np.isfinite(o[-1])
        ok = ((np.linalg.norm(o[0] - gt["rotation"], axis=(-1, -2)) < tol)
              & (np.linalg.norm(o[1] - gt["translation"], axis=-1) < tol))
        if name == "gdls":
            ok &= np.abs(o[2] / gt["scale"] - 1) < tol
    elif name == "orthographic":
        ok = ((np.linalg.norm(o[0][..., :2, :] - gt["rotation"][:, None, :2], axis=(-1, -2)) < tol)
              & (np.abs(o[2] / gt["magnification"] - 1) < tol)[:, None])
    else:
        t = o[1]
        if name == "three_point_partial":
            t = t / np.linalg.norm(t, axis=-1, keepdims=True)
            terr = np.minimum(np.linalg.norm(t - gt["translation"][:, None], axis=-1),
                              np.linalg.norm(t + gt["translation"][:, None], axis=-1))
        else:
            terr = np.linalg.norm(t - gt["translation"][:, None], axis=-1)
        ok = (np.linalg.norm(o[0] - gt["rotation"][:, None], axis=(-1, -2)) < tol) & (terr < tol)
        if name == "sim_partial":
            ok &= np.abs(o[2] / gt["scale"][:, None] - 1) < tol
    ok = ok & valid
    return ok.reshape(ok.shape[0], -1).any(-1)


def agreement(name, a, b, rtol=1e-4):
    """[count] whether two runs of solver `name` give the same set of valid
    solutions: each valid solution of either is one of the other's valid
    solutions to rtol (relative, absolute below 1). Sets, not slots: where
    more candidates converge than a solver keeps, which duplicates fill its
    slots is the rounding's."""
    sa, va = solutions(name, a)
    sb, vb = solutions(name, b)
    diff = np.abs(sa[:, :, None] - sb[:, None])
    scale = np.maximum(1.0, np.minimum(np.abs(sa[:, :, None]), np.abs(sb[:, None])))
    close = np.all(diff <= rtol * scale, axis=-1)  # [count, Sa, Sb]
    a_in_b = np.all(~va | np.any(close & vb[:, None, :], axis=-1), axis=-1)
    b_in_a = np.all(~vb | np.any(close & va[:, :, None], axis=-2), axis=-1)
    return a_in_b & b_in_a


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
    return out, time.perf_counter() - t0, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card by default")
    ap.add_argument("--samples", type=int, default=16384)
    ap.add_argument("--only", nargs="*", default=None, help="estimators / solvers to run")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    t0 = time.perf_counter()
    problems = build_problems()
    print(f"problems built in {time.perf_counter() - t0:.2f} s", flush=True)
    for name in ESTIMATORS:
        if args.only and name not in args.only:
            continue
        for label in ("first", "warm"):
            gen = torch.Generator(device=dev).manual_seed(0)
            (model, summary), secs, peak = _timed(
                lambda: run_estimator(problems, name, gen, dev), dev)
            err = summarize(estimator_errors(name, model, summary.num_inliers.cpu().numpy(),
                                             problems))
            print(f"[{name} {label}] {problems[name]['mask'].shape} at {ITERATIONS[name]} "
                  f"hypotheses: {secs:.3f} s, peak device memory {peak:.2f} GiB; {err}",
                  flush=True)
    for name in SOLVERS:
        if args.only and name not in args.only:
            continue
        inputs, gt = minimal_samples(name, args.samples)
        out, secs, peak = _timed(lambda: solve(name, inputs, dev), dev)
        print(f"[{name}] {args.samples} samples: {secs:.3f} s, peak device memory {peak:.2f} "
              f"GiB; recovered {float(np.mean(recovered(name, out, gt)))!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
