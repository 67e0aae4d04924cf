"""The port's UPnP, MLPnP and gDLS (`ops/generalized_pose.py`) against the
JAX package's on the same inputs, f64: one JAX call a solver, on a batch
that holds every case of `tests/test_generalized_pose.py` (central and
non-central rays; identity and anisotropic covariances; scaled worlds),
made from numpy seeds. Bars: rotations, translations and scales to 1e-8
(the solvers' exact minima), the costs to 1e-20 absolute, and the JAX
test's ground truth at its tolerances wherever the JAX package meets it.

Each JAX solver takes 5-14 s of one CPU core to trace and compile,
so its outputs on these inputs are recorded in
`tests/data/torch_generalized_pose_jax.npz` by
`JAX_PLATFORMS=cpu python tests/torch_minimal_solvers_reference.py record`,
and `test_record_is_the_jax_package_s` (`slow`) computes them again.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytheiasfm_tpu_torch.ops import generalized_pose as tgp
from test_generalized_pose import _rot
from test_torch_track_estimator import one_cpu_thread  # noqa: F401  (autouse)

RECORD = Path(__file__).resolve().parent / "data" / "torch_generalized_pose_jax.npz"
TOL = 1e-8
N = 8


def ray_cases(scales):
    """Rays of a generalized camera [B, N, 3] x 2 (origins zero for the
    even problems: central), world points [B, N, 3], ground truth."""
    o, d, X, gt = [], [], [], []
    for i, s in enumerate(scales):
        rng = np.random.default_rng(21 + i)
        R = _rot(rng)
        t = rng.uniform(-1, 1, 3)
        Xw = rng.uniform(-2, 2, (N, 3)) + np.array([0, 0, 6.0])
        orig = rng.uniform(-0.4, 0.4, (N, 3)) * (i % 2)
        dirs = s * (R @ Xw.T).T + t - orig
        o.append(orig)
        d.append(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
        X.append(Xw)
        gt.append((R, t, s))
    return np.stack(o), np.stack(d), np.stack(X), gt


def mlpnp_cases():
    """Normalized features [B, 12, 2], covariances [B, 12, 3, 3] (identity
    for the even problems), world points, ground truth."""
    feats, covs, X, gt = [], [], [], []
    for i in range(4):
        rng = np.random.default_rng(23 + i)
        R = _rot(rng)
        t = np.array([0.2, 0.4, 1.5]) + rng.uniform(-0.3, 0.3, 3)
        Xw = rng.uniform(-2, 2, (12, 3)) + np.array([0, 0, 7.0])
        Xc = (R @ Xw.T).T + t
        A = rng.normal(size=(12, 3, 3)) * 0.3
        cov = np.einsum("nij,nkj->nik", A, A) + np.eye(3) * 0.5
        feats.append(Xc[:, :2] / Xc[:, 2:3])
        covs.append(np.broadcast_to(np.eye(3), (12, 3, 3)) if i % 2 == 0 else cov)
        X.append(Xw)
        gt.append((R, t))
    return np.stack(feats), np.stack(covs), np.stack(X), gt


def cases():
    """name -> (the solver's inputs, ground truth)."""
    o, d, X, gt = ray_cases([1.0] * 6)
    so, sd, sX, sgt = ray_cases([2.3, 1.7, 0.6, 1.0, 3.1, 0.9])
    feats, covs, mX, mgt = mlpnp_cases()
    return {"upnp": ((o, d, X), gt), "gdls_similarity_transform": ((so, sd, sX), sgt),
            "mlpnp": ((feats, covs, mX), mgt)}


def jax_outputs():
    """name -> the JAX package's outputs on its cases (one call a solver)."""
    import jax.numpy as jnp

    from pytheiasfm_tpu.ops import generalized_pose as jgp

    return {name: [np.asarray(x) for x in getattr(jgp, name)(*map(jnp.asarray, inputs))]
            for name, (inputs, _) in cases().items()}


def save_record(path=RECORD):
    arrays = {}
    for name, outs in jax_outputs().items():
        arrays.update({f"{name}/out{j}": x for j, x in enumerate(outs)})
        arrays.update({f"{name}/in{j}": x for j, x in enumerate(cases()[name][0])})
    np.savez_compressed(path, **arrays)


def _solved(name):
    """(JAX outputs as recorded, the port's outputs), ground truth."""
    inputs, gt = cases()[name]
    with np.load(RECORD) as z:
        rec = dict(z)
    for j, x in enumerate(inputs):
        np.testing.assert_array_equal(rec[f"{name}/in{j}"], x)  # the record's inputs
    want = [rec[f"{name}/out{j}"] for j in range(sum(k.startswith(f"{name}/out") for k in rec))]
    got = [x.numpy() for x in getattr(tgp, name)(
        *(torch.tensor(np.ascontiguousarray(a)) for a in inputs))]
    return (want, got), gt


@pytest.fixture(scope="module")
def upnp():
    return _solved("upnp")


@pytest.fixture(scope="module")
def gdls():
    return _solved("gdls_similarity_transform")


@pytest.fixture(scope="module")
def mlpnp():
    return _solved("mlpnp")


def _match(want, got, tol=TOL):
    for w, g in zip(want[:-1], got[:-1]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    np.testing.assert_allclose(got[-1], want[-1], rtol=0, atol=1e-20)


def test_upnp_matches_the_jax_package(upnp):
    _match(*upnp[0])


def test_gdls_matches_the_jax_package(gdls):
    _match(*gdls[0])


def test_mlpnp_matches_the_jax_package(mlpnp):
    _match(*mlpnp[0])


def _recovered(fixture, hit):
    """hit(outputs, b, ground truth) for each problem in both packages: the
    port recovers every problem the JAX package recovers, and at least one."""
    (want, got), gt = fixture
    jax_hits = [hit(want, b, g) for b, g in enumerate(gt)]
    port_hits = [hit(got, b, g) for b, g in enumerate(gt)]
    assert any(port_hits) and all(p or not j for p, j in zip(port_hits, jax_hits)), (
        jax_hits, port_hits)


def test_upnp_recovers_ground_truth(upnp):
    _recovered(upnp, lambda out, b, g: np.linalg.norm(out[0][b] - g[0]) < 1e-5
               and np.linalg.norm(out[1][b] - g[1]) < 1e-5)


def test_gdls_recovers_ground_truth(gdls):
    _recovered(gdls, lambda out, b, g: np.linalg.norm(out[0][b] - g[0]) < 1e-5
               and np.linalg.norm(out[1][b] - g[1]) < 1e-4 and abs(out[2][b] - g[2]) < 1e-4)


def test_mlpnp_recovers_ground_truth(mlpnp):
    _recovered(mlpnp, lambda out, b, g: np.linalg.norm(out[0][b] - g[0]) < 1e-4
               and np.linalg.norm(out[1][b] - g[1]) < 1e-4)


def test_f32_upnp_recovers_ground_truth():
    """In f32 (the card's precision) UPnP still lands within 1e-3."""
    o, d, X, gt = ray_cases([1.0] * 6)
    R, t, _ = tgp.upnp(*(torch.tensor(a, dtype=torch.float32) for a in (o, d, X)))
    for b, (R_gt, t_gt, _) in enumerate(gt):
        assert np.linalg.norm(R[b].numpy() - R_gt) < 1e-3
        assert np.linalg.norm(t[b].numpy() - t_gt) < 1e-3


@pytest.mark.slow
def test_record_is_the_jax_package_s():
    """The JAX package on the record's inputs gives the record (1e-10: its
    rounding on another CPU)."""
    with np.load(RECORD) as z:
        rec = dict(z)
    for name, outs in jax_outputs().items():
        _match([rec[f"{name}/out{j}"] for j in range(len(outs))], outs, tol=1e-10)
