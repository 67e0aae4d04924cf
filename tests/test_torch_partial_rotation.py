"""The port's known-axis minimal solvers (`ops/partial_rotation.py`) against
the JAX package's on the same inputs, f64: one JAX call a solver, on a
batch that holds every angle of `tests/test_partial_rotation.py` (and more,
from numpy seeds), with that file's axes. Bars: the valid masks equal,
rotations, translations and scales to 1e-8 (the three-point translation, a
3x3 SVD's null vector, up to its sign), and the JAX test's ground truth.

Each JAX solver takes 9-13 s of one CPU core to trace and compile,
so its outputs on these inputs are recorded in
`tests/data/torch_partial_rotation_jax.npz` by
`JAX_PLATFORMS=cpu python tests/torch_minimal_solvers_reference.py record`,
and `test_record_is_the_jax_package_s` (`slow`) computes them again.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.ops import partial_rotation as jpr
from pytheiasfm_tpu_torch.ops import partial_rotation as tpr
from test_partial_rotation import _axis_rot
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

RECORD = Path(__file__).resolve().parent / "data" / "torch_partial_rotation_jax.npz"
TOL = 1e-8


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def two_point_cases():
    axis = _unit([0.2, 1.0, -0.3])
    rng = np.random.default_rng(11)
    pts, rays, gt = [], [], []
    for angle in [0.3, -0.9, 1.7, 2.6, -2.2, 0.05]:
        R = _axis_rot(axis, angle)
        t = np.array([0.4, -0.2, 0.6]) + rng.uniform(-0.3, 0.3, 3)
        p = rng.uniform(-2, 2, (2, 3)) + np.array([0, 0, 6.0])
        pts.append(p)
        rays.append((R @ p.T).T + t)
        gt.append((R, t))
    return axis, (np.stack(pts), np.stack(rays)), gt


def three_point_cases():
    axis = np.array([0.0, 1.0, 0.0])
    rng = np.random.default_rng(12)
    r1, r2, gt = [], [], []
    for angle in [0.5, -1.2, 1.9, -0.3]:
        R = _axis_rot(axis, angle)
        t = _unit(np.array([1.0, 0.3, -0.5]) + rng.uniform(-0.3, 0.3, 3))
        p = rng.uniform(-2, 2, (3, 3)) + np.array([0, 0, 8.0])
        r1.append(p)
        r2.append((R @ p.T).T + t)
        gt.append((R, t))
    return axis, (np.stack(r1), np.stack(r2)), gt


def generalized_cases(n, scales, seed):
    """Directions and origins of two generalized cameras [B, n, 3] x 4 with
    X2 = s R X1 + t."""
    axis = _unit([0.3, 0.2, 1.0] if n == 4 else [1.0, 0.1, -0.2])
    rng = np.random.default_rng(seed)
    d1, o1, d2, o2, gt = [], [], [], [], []
    for i, s in enumerate(scales):
        R = _axis_rot(axis, [0.7, -0.6, 1.4, -1.9][i])
        t = np.array([0.8, -0.4, 0.2]) + rng.uniform(-0.3, 0.3, 3)
        p = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 10.0])
        a, b = rng.uniform(-0.2, 0.2, (2, n, 3))
        d1.append(p - a)
        o1.append(a)
        d2.append(s * (R @ p.T).T + t - b)
        o2.append(b)
        gt.append((R, t, s))
    return axis, tuple(map(np.stack, (d1, o1, d2, o2))), gt


CASES = {
    "two_point_pose_partial_rotation": two_point_cases,
    "three_point_relative_pose_partial_rotation": three_point_cases,
    "four_point_relative_pose_partial_rotation": lambda: generalized_cases(4, [1.0] * 4, 13),
    "sim_transform_partial_rotation": lambda: generalized_cases(5, [1.7, 0.8, 2.5, 1.2], 14),
}


def jax_outputs():
    """name -> the JAX package's outputs on that solver's cases (one call a
    solver)."""
    out = {}
    for name, cases in CASES.items():
        axis, arrays, _ = cases()
        out[name] = [np.asarray(x) for x in getattr(jpr, name)(jnp.asarray(axis),
                                                               *map(jnp.asarray, arrays))]
    return out


def save_record(path=RECORD):
    arrays = {}
    for name, outs in jax_outputs().items():
        axis, inputs, _ = CASES[name]()
        arrays.update({f"{name}/in{j}": x for j, x in enumerate((axis,) + tuple(inputs))})
        arrays.update({f"{name}/out{j}": x for j, x in enumerate(outs)})
    np.savez_compressed(path, **arrays)


def load_record():
    """name -> (inputs, outputs) as recorded."""
    with np.load(RECORD) as z:
        rec = dict(z)

    def listed(prefix):
        return [rec[f"{prefix}{j}"] for j in range(sum(k.startswith(prefix) for k in rec))]

    return {name: (listed(f"{name}/in"), listed(f"{name}/out")) for name in CASES}


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    name = request.param
    axis, arrays, gt = CASES[name]()
    inputs, want = load_record()[name]
    for r, x in zip(inputs, (axis,) + tuple(arrays)):
        np.testing.assert_array_equal(r, x)  # the record was made on these inputs
    got = [x.numpy() for x in getattr(tpr, name)(torch.tensor(axis),
                                                 *map(torch.tensor, arrays))]
    return name, list(want), got, gt


def _compare(name, want, got, tol=TOL):
    valid = want[-1]
    np.testing.assert_array_equal(got[-1], valid)
    for i, (w, g) in enumerate(zip(want[:-1], got[:-1])):
        w, g = w[valid], g[valid]
        if name.startswith("three") and i == 1:
            # The null vector's sign is the SVD's.
            g = g * np.sign(np.sum(g * w, axis=-1, keepdims=True))
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_matches_the_jax_package(solved):
    name, want, got, _ = solved
    assert want[-1].any()
    _compare(name, want, got)


def _gt_error(name, out, b, g):
    """The least error of a valid solution against the ground truth."""
    errs = [np.inf]
    for k in np.flatnonzero(out[-1][b]):
        t = out[1][b, k]
        if name.startswith("three"):
            t = t / np.linalg.norm(t)
            terr = min(np.linalg.norm(t - g[1]), np.linalg.norm(t + g[1]))
        else:
            terr = np.linalg.norm(t - g[1])
        err = np.linalg.norm(out[0][b, k] - g[0]) + terr
        if name.startswith("sim"):
            err += abs(out[2][b, k] - g[2])
        errs.append(err)
    return min(errs)


def test_recovers_ground_truth(solved):
    """The JAX test's tolerances (1e-6, 1e-5 for the generalized solvers):
    a valid solution at the ground truth on every problem where the JAX
    package has one, and on at least one problem."""
    name, want, got, gt = solved
    tol = 1e-6 if name.startswith(("two", "three")) else 1e-5
    for b, g in enumerate(gt):
        if _gt_error(name, want, b, g) < tol:
            assert _gt_error(name, got, b, g) < tol, (name, b)
    assert any(_gt_error(name, got, b, g) < tol for b, g in enumerate(gt)), name


def test_axis_rotation_matrix():
    axis = _unit([0.3, -0.5, 0.8])
    w = np.array([-2.0, -0.3, 0.0, 0.7, 5.0])
    want = np.asarray(jpr.axis_rotation_matrix(jnp.asarray(axis), jnp.asarray(w)))
    got = tpr.axis_rotation_matrix(torch.tensor(axis), torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    for k, wk in enumerate(w):
        np.testing.assert_allclose(got[k], _axis_rot(axis, 2 * np.arctan(wk)), atol=1e-12)


@pytest.mark.slow
def test_record_is_the_jax_package_s():
    """The JAX package on the record's inputs gives the record (the valid
    entries to 1e-10: its rounding on another CPU)."""
    rec = load_record()
    for name, outs in jax_outputs().items():
        _compare(name, list(rec[name][1]), outs, tol=1e-10)
