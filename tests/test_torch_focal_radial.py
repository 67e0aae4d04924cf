"""The port's P4Pf, P5Pfr (one and two distortion parameters) and P4Pfr
(`ops/focal_radial.py`) against the JAX package's on the same inputs, f64.

The inputs are the JAX test's scenes (`tests/test_focal_radial._make_scene`:
random poses, points 5 units ahead, division-model distortion), eight
problems a solver, made from numpy seeds. Each JAX solver traces one P3P a
candidate (7 to 28) and takes 12-37 s of one CPU core to trace and
compile at any batch size, so its outputs on these inputs are recorded once
in `tests/data/torch_focal_radial_jax.npz` by

    JAX_PLATFORMS=cpu python tests/torch_minimal_solvers_reference.py record

and `test_record_is_the_jax_package_s` (`slow`) computes them again.

Where more than four candidates of a sample converge to exact solutions
(errors at rounding level), which four the final sort keeps is the
rounding's (the JAX package against itself on another CPU too). So the
record also holds every candidate of the shared grid solver (`_grid_solve`
with all candidates kept), and the bars are: every candidate with an error
under the tolerance equal, as a multiset, to 1e-8 (relative, or absolute
below 1); the public outputs' valid masks equal; each valid output the
same solution as one of the JAX package's valid candidates, to 1e-8; and
at least as many problems as the JAX package's meet the JAX test's
ground-truth bars.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytheiasfm_tpu_torch.ops import focal_radial as tfr
from test_focal_radial import _make_scene
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

RECORD = Path(__file__).resolve().parent / "data" / "torch_focal_radial_jax.npz"
TOL = 1e-8
B = 8
P4PFR_BOUNDS = dict(min_focal_length=100.0, max_focal_length=5000.0, min_distortion=-1.0,
                    max_distortion=0.0)
# The solvers' distortion seeds (`_grid_solve`'s k_grid, as in both packages).
K_SEEDS = {
    "p4pf": (0, None),
    "p5pfr1": (1, np.array([[0.0], [-0.1], [-0.3]])),
    "p5pfr2": (2, np.array([[0.0, 0.0], [-0.1, 0.0], [-0.3, 0.0]])),
    "p4pfr": (1, np.array([[0.0], [-0.05], [-0.15], [-0.35]])),
}
# name -> (number of points, distortion k1 of each problem)
CASES = {
    "p4pf": (4, [0.0] * B),
    "p5pfr1": (5, [-0.05, -0.1, -0.2, -0.3, -0.02, -0.15, -0.25, -0.4]),
    "p5pfr2": (5, [-0.05, -0.1, -0.2, -0.3, -0.02, -0.15, -0.25, -0.4]),
    # k1 inside the bounds: at k1 = 0 its sign, and so its validity, is the
    # rounding's.
    "p4pfr": (4, [-0.1, -0.05, -0.2, -0.3, -0.02, -0.12, -0.08, -0.25]),
}


def focal_cases():
    """name -> (pixels [B, n, 2], world [B, n, 3], focal [B], k1 [B],
    rotation [B, 3, 3]), from numpy seeds."""
    out = {}
    for i, (name, (n, ks)) in enumerate(CASES.items()):
        rng = np.random.default_rng(100 + i)
        fs = rng.uniform(400.0, 1600.0, B)
        scenes = [_make_scene(rng, n, f, k) for f, k in zip(fs, ks)]
        out[name] = (np.stack([s[3] for s in scenes]), np.stack([s[2] for s in scenes]),
                     fs, np.asarray(ks), np.stack([s[0] for s in scenes]))
    return out


def run(module, name, pix, world):
    """The solver `name` of `module` (either package's `ops.focal_radial`) on
    arrays of that package; its outputs as a tuple."""
    if name == "p4pf":
        return module.four_point_pose_and_focal_length(pix, world)
    if name.startswith("p5pfr"):
        return module.five_point_focal_length_radial_distortion(pix, world, int(name[-1]))
    return module.four_point_pose_focal_length_radial_distortion(pix, world, **P4PFR_BOUNDS)


def candidates(module, name, pix, world):
    """Every candidate of the grid solver behind `name`, sorted by error:
    (params [B, C, 7 + num_k], err [B, C])."""
    num_k, k_grid = K_SEEDS[name]
    C = 7 * (1 if k_grid is None else k_grid.shape[0])
    return module._grid_solve(pix, world, num_k=num_k, k_grid=k_grid, iters=10,
                              max_solutions=C)


def jax_outputs(cases):
    """The JAX package's outputs on `cases`: name -> (public outputs,
    candidates), each a tuple of arrays."""
    import jax.numpy as jnp

    from pytheiasfm_tpu.ops import focal_radial as jfr

    out = {}
    for name, (pix, world, *_) in cases.items():
        args = (jfr, name, jnp.asarray(pix), jnp.asarray(world))
        out[name] = (tuple(np.asarray(x) for x in run(*args)),
                     tuple(np.asarray(x) for x in candidates(*args)))
    return out


def save_record(path=RECORD):
    cases = focal_cases()
    arrays = {f"{name}/in{j}": x for name, c in cases.items() for j, x in enumerate(c[:2])}
    for name, (outs, cands) in jax_outputs(cases).items():
        arrays.update({f"{name}/out{j}": x for j, x in enumerate(outs)})
        arrays.update({f"{name}/cand{j}": x for j, x in enumerate(cands)})
    np.savez_compressed(path, **arrays)


def load_record():
    """name -> (public outputs, candidates); name + "/inputs" -> inputs."""
    with np.load(RECORD) as z:
        rec = dict(z)
    out = {}
    for name in CASES:
        outs = tuple(rec[f"{name}/out{j}"] for j in range(
            sum(k.startswith(f"{name}/out") for k in rec)))
        out[name] = (outs, (rec[f"{name}/cand0"], rec[f"{name}/cand1"]))
        out[name + "/inputs"] = (rec[f"{name}/in0"], rec[f"{name}/in1"])
    return out


@pytest.fixture(scope="module")
def both():
    cases = focal_cases()
    rec = load_record()
    mine = {}
    for name, (pix, world, *_) in cases.items():
        # The record was made on these very inputs.
        np.testing.assert_array_equal(rec[name + "/inputs"][0], pix)
        np.testing.assert_array_equal(rec[name + "/inputs"][1], world)
        args = (tfr, name, torch.tensor(pix), torch.tensor(world))
        mine[name] = (tuple(x.numpy() for x in run(*args)),
                      tuple(x.numpy() for x in candidates(*args)))
    return cases, rec, mine


def _close(a, b, tol=TOL):
    return np.all(np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b)))


def _solution(params, num_k):
    """(R, t, f, k...) of candidate params as one vector."""
    R = tfr.angle_axis_to_rotation_matrix(torch.tensor(params[..., :3])).numpy()
    return np.concatenate([R.reshape(*R.shape[:-2], 9), params[..., 3:6],
                           np.exp(params[..., 6:7]), params[..., 7:7 + num_k]], axis=-1)


def _matched(want, got, tol=TOL):
    """Whether the rows of got [n, d] are those of want [n, d] up to order."""
    if len(want) != len(got):
        return False
    free = list(range(len(got)))
    for w in want:
        hit = next((i for i in free if _close(got[i], w, tol)), None)
        if hit is None:
            return False
        free.remove(hit)
    return True


def _valid_candidates(cands, num_k, tol):
    """Per problem the solutions [n, d] of the candidates with error < tol
    and a focal length of a pixel or more: below it the pixel residual,
    scaled by f, vanishes with f, and the collapsed candidates' poses are
    the rounding's (ROADMAP.md, section 3)."""
    params, err = cands
    sol = _solution(params, num_k)
    return [sol[b][(err[b] < tol) & (sol[b][:, 12] >= 1.0)] for b in range(len(err))]


@pytest.mark.parametrize("name", list(CASES))
def test_candidates_match_the_jax_package(both, name):
    """Every grid candidate that converges (error < 1e-8) to a focal length
    of a pixel or more: the same multiset of solutions in both packages,
    sample for sample."""
    _, rec, mine = both
    num_k = K_SEEDS[name][0]
    want = _valid_candidates(rec[name][1], num_k, 1e-8)
    got = _valid_candidates(mine[name][1], num_k, 1e-8)
    assert sum(len(w) for w in want) > 0
    for b, (w, g) in enumerate(zip(want, got)):
        assert _matched(w, g), (name, b, len(w), len(g))


def _outputs_as_solutions(name, outs):
    """The public outputs as (R, t, f, k...) rows [B, 4, d] and valid."""
    if name == "p4pf" or name.startswith("p5pfr"):
        P, f = outs[0], outs[1]
        Rt = P / np.stack([f, f, np.ones_like(f)], -1)[..., None]
        parts = [Rt[..., :3].reshape(*f.shape, 9), Rt[..., 3], f[..., None]]
        if name.startswith("p5pfr"):
            parts.append(outs[2])
    else:
        R, t, k1, f = outs[:4]
        parts = [R.reshape(*f.shape, 9), t, f[..., None], k1[..., None]]
    return np.concatenate(parts, axis=-1), outs[-1]


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_match_the_jax_package(both, name):
    """The public outputs: the valid masks equal, and each valid output one
    of the JAX package's valid candidates to 1e-8."""
    _, rec, mine = both
    num_k = K_SEEDS[name][0]
    want_valid = rec[name][0][-1]
    sol, valid = _outputs_as_solutions(name, mine[name][0])
    np.testing.assert_array_equal(valid, want_valid)
    pool = _valid_candidates(rec[name][1], num_k, 1e-8)
    for b in range(len(valid)):
        for k in np.flatnonzero(valid[b] & (sol[b, :, 12] >= 1.0)):
            assert any(_close(sol[b, k], c) for c in pool[b]), (name, b, k)


def _recovered(name, outs, fs, ks, Rs):
    """Per problem, whether a valid output meets the JAX test's bars
    (focal 1-2%, the rotation or the distortion)."""
    hits = []
    for b in range(len(fs)):
        ok = False
        for k in np.flatnonzero(outs[-1][b]):
            if name == "p4pf":
                f = outs[1][b, k]
                R = outs[0][b, k][:, :3] / np.array([f, f, 1.0])[:, None]
                ok |= abs(f - fs[b]) / fs[b] < 1e-2 and np.linalg.norm(R - Rs[b]) < 1e-2
            elif name.startswith("p5pfr"):
                ok |= abs(outs[1][b, k] - fs[b]) / fs[b] < 2e-2 and abs(
                    outs[2][b, k, 0] - ks[b]) < 5e-2
            else:
                ok |= abs(outs[3][b, k] - fs[b]) / fs[b] < 2e-2 and np.linalg.norm(
                    outs[0][b, k] - Rs[b]) < 2e-2
        hits.append(bool(ok))
    return np.array(hits)


@pytest.mark.parametrize("name", list(CASES))
def test_recovers_ground_truth(both, name):
    """The JAX test's bars on at least as many problems as the JAX
    package's outputs meet them (and on at least one)."""
    cases, rec, mine = both
    _, _, fs, ks, Rs = cases[name]
    want = _recovered(name, rec[name][0], fs, ks, Rs)
    got = _recovered(name, mine[name][0], fs, ks, Rs)
    assert got.sum() >= max(want.sum(), 1), (want, got)


def test_f32_recovers_ground_truth(both):
    """In f32 (the card's precision) P4Pf still finds the focal length of
    most problems, at the f32 validity tolerance."""
    cases, _, _ = both
    pix, world, fs, _, _ = cases["p4pf"]
    P, f, valid = tfr.four_point_pose_and_focal_length(
        torch.tensor(pix, dtype=torch.float32), torch.tensor(world, dtype=torch.float32))
    hits = [any(valid[b, k] and abs(float(f[b, k]) - fs[b]) / fs[b] < 1e-2 for k in range(4))
            for b in range(B)]
    assert np.mean(hits) >= 0.75, hits


@pytest.mark.slow
def test_record_is_the_jax_package_s():
    """The JAX package on the record's inputs gives the record (the valid
    entries to 1e-10: its rounding on another CPU)."""
    outs = jax_outputs(focal_cases())
    rec = load_record()
    for name in CASES:
        num_k = K_SEEDS[name][0]
        np.testing.assert_array_equal(outs[name][0][-1], rec[name][0][-1])
        want = _valid_candidates(rec[name][1], num_k, 1e-8)
        got = _valid_candidates(outs[name][1], num_k, 1e-8)
        assert all(_matched(w, g, 1e-10) for w, g in zip(want, got)), name
