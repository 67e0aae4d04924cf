"""The port's estimators on a device mesh: a CPU mesh of 4 gloo ranks
against one rank (f64 where the JAX tests' bars are f64's) and against the
JAX package's mesh runs on the same inputs.

The 4 ranks start once for the module (`tests/torch_mesh_cases.py`, suite
"sfm"), run every case on the mesh and alone, and hand their results back.
The JAX package's outputs are recorded in `tests/data/torch_mesh_jax.npz`
(`tests/torch_mesh_reference.py`: its 8-device virtual CPU mesh, about a
minute of JAX traces), and `test_record_is_the_jax_package_s` (`slow`)
computes them again. The counterparts of `tests/test_multichip.py:56,
:106, :127, :168, :202, :237, :259, :282` and `tests/test_multihost.py:56`;
edge, track and observation counts that 4 does not divide, so that the
masked padding runs.

Bars, the mesh against one rank: the JAX tests' (flat kernel cost 1e-9,
state 1e-8; the BA entry 1e-7 / 1e-8, focal 1e-6; rotations and LUD 1e-6 /
1e-8; triangulation the same tracks, points 1e-6 / 1e-9; the dense Schur
1e-8, cost 1e-10; the matcher's indices equal). The mesh against the JAX
package's mesh: the port's single-device parity bars for each function
(BA f64 state 1e-7, cost 1e-8; rotations 1e-8 rad; positions 1e-8 of the
scale; triangulation 1e-8; matcher indices equal; `estimate` the same views,
tracks within 1%, positions 1e-4 of the scene's radius after a similarity).
"""

import numpy as np
import pytest
import torch

import torch_mesh_reference as ref
from torch_mesh_cases import run_suite

WORLD = 4


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    return run_suite("sfm", tmp_path_factory.mktemp("mesh"), WORLD)


@pytest.fixture(scope="module")
def ranks(suite):
    return suite[0]


@pytest.fixture(scope="module")
def single(suite):
    return suite[1]


@pytest.fixture(scope="module")
def record():
    return dict(np.load(ref.RECORD))


def _rotation_gap(a, b):
    from pytheiasfm_tpu_torch.ops.rotation_np import (
        angle_axis_to_rotation_matrix_np,
        rotation_matrix_to_angle_axis_np,
    )

    Ra, Rb = angle_axis_to_rotation_matrix_np(a), angle_axis_to_rotation_matrix_np(b)
    gap = rotation_matrix_to_angle_axis_np(Ra @ np.swapaxes(Rb, -1, -2))
    return float(np.max(np.linalg.norm(gap, axis=-1)))


def test_flat_kernel_on_sharded_observations(ranks, single, record):
    s = single["flat"]
    for res in ranks:
        m = res["flat"]
        assert m["pcg"] == s["pcg"]
        np.testing.assert_allclose(m["cost"], s["cost"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(m["ext"], s["ext"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(m["pts"], s["pts"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(m["cost"], float(record["jax__flat__cost"]), rtol=1e-8)
        np.testing.assert_allclose(m["ext"], record["jax__flat__ext"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(m["pts"], record["jax__flat__pts"], rtol=0, atol=1e-7)


def test_matcher_on_sharded_pairs(ranks, single, record):
    s = single["matcher"]
    for res in ranks:
        m = res["matcher"]
        assert m["pairs"] == 3  # 10 pairs padded to 12
        np.testing.assert_array_equal(m["idx"], s["idx"])
        np.testing.assert_allclose(m["dist"], s["dist"], rtol=1e-6)
        np.testing.assert_array_equal(m["idx"], record["jax__matcher__idx"])
        fin = np.isfinite(record["jax__matcher__dist"])
        np.testing.assert_array_equal(np.isfinite(m["dist"]), fin)
        np.testing.assert_allclose(m["dist"][fin], record["jax__matcher__dist"][fin], rtol=1e-6)


@pytest.mark.parametrize("case,solver", [("entry_dense", "dense"),
                                         ("entry_iterative", "iterative")])
def test_ba_entry_on_a_mesh(ranks, single, record, case, solver):
    s = single[case]
    for res in ranks:
        m = res[case]
        assert m["success"] and s["success"]
        assert m["solver"] == s["solver"] == solver
        assert m["iterations"] == s["iterations"]
        np.testing.assert_allclose(m["ext"], s["ext"], rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(m["cost"], s["cost"], rtol=1e-6, atol=1e-18)
        np.testing.assert_allclose(m["intrinsics"][0, 0], s["intrinsics"][0, 0], rtol=1e-6)
        np.testing.assert_allclose(m["ext"], record[f"jax__{case}__ext"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(m["intrinsics"], record[f"jax__{case}__intrinsics"],
                                   rtol=1e-7)
        np.testing.assert_allclose(m["cost"], float(record[f"jax__{case}__cost"]), rtol=1e-6,
                                   atol=1e-18)


def test_rotation_averaging_on_sharded_edges(ranks, single, record):
    from pytheiasfm_tpu_torch.ops.rotation import align_orientations

    def rotation_error_rad(gt, est):  # after the gauge alignment
        aligned = align_orientations(torch.as_tensor(gt), torch.as_tensor(est)).numpy()
        return _rotation_gap(aligned, gt)

    s = single["rotations"]["out"]
    for res in ranks:
        r = res["rotations"]
        np.testing.assert_allclose(r["out"], s, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(r["sparse"], s, rtol=1e-6, atol=1e-8)
        assert _rotation_gap(r["out"], record["jax__rotations__out"]) <= 1e-8
        gt = record["rotations__gt_aa"]
        assert np.degrees(rotation_error_rad(gt, r["out"])) < 1.5


def test_lud_on_sharded_edges(ranks, single, record):
    s = single["positions"]["out"]
    scale = np.median(np.linalg.norm(s - s.mean(0), axis=-1))
    for res in ranks:
        p = res["positions"]["out"]
        np.testing.assert_allclose(p, s, rtol=1e-6, atol=1e-8)
        assert np.max(np.abs(p - record["jax__positions__out"])) <= 1e-8 * scale


def test_triangulation_on_sharded_tracks(ranks, single, record):
    s = single["triangulation"]
    for res in ranks:
        m = res["triangulation"]
        assert m["estimated"] == s["estimated"]
        assert len(m["estimated"]) > 100
        np.testing.assert_allclose(m["points"], s["points"], rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(m["estimated"], record["jax__triangulation__estimated"])
        np.testing.assert_allclose(m["points"], record["jax__triangulation__points"], rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("T", ["64", "62"])
def test_dense_schur_explicit_collectives(ranks, single, record, T):
    s = single["dense"][T]
    for res in ranks:
        m = res["dense"][T]
        assert m["iterations"] == s["iterations"]
        np.testing.assert_allclose(m["ext"], s["ext"], rtol=0, atol=1e-8)
        np.testing.assert_allclose(m["pts"], s["pts"], rtol=0, atol=1e-8)
        np.testing.assert_allclose(m["cost"], s["cost"], rtol=1e-10)
        if T == "64":
            np.testing.assert_allclose(m["ext"], record["jax__dense__ext_out"], rtol=0, atol=1e-7)
            np.testing.assert_allclose(m["pts"], record["jax__dense__pts_out"], rtol=0, atol=1e-7)
            np.testing.assert_allclose(m["cost"], float(record["jax__dense__cost"]), rtol=1e-8)


def test_estimate_on_a_mesh(ranks, single, record):
    from pytheiasfm_tpu_torch.transforms.alignment import align_point_clouds_umeyama

    def aligned_gap(a, b):
        R, t, sc = align_point_clouds_umeyama(torch.as_tensor(a), torch.as_tensor(b))
        return np.linalg.norm(float(sc) * a @ R.numpy().T + t.numpy() - b, axis=-1)

    s = single["estimate"]
    radius = np.median(np.linalg.norm(s["positions"] - s["positions"].mean(0), axis=-1))
    for res in ranks:
        m = res["estimate"]
        assert m["success"] and s["success"]
        assert m["views"] == s["views"] and len(m["views"]) >= 20
        assert m["tracks"] == s["tracks"]
        assert m["rounds"] == s["rounds"]
        assert m["pose_ids"] == s["pose_ids"]
        assert _rotation_gap(m["orientations"], s["orientations"]) <= 1e-6
        assert np.max(np.abs(m["positions"] - s["positions"])) <= 1e-6 * radius
        ids = m["views"]
        assert np.median(aligned_gap(m["ext"][ids, :3], m["gt"][ids])) < 0.05
        # Against the JAX package's mesh run.
        assert list(record["jax__estimate__views"]) == m["views"]
        sym = set(m["tracks"]) ^ set(record["jax__estimate__tracks"].tolist())
        assert len(sym) <= 0.01 * len(m["tracks"]), len(sym)
        scene_radius = np.median(np.linalg.norm(m["gt"] - m["gt"].mean(0), axis=-1))
        gap = aligned_gap(m["ext"][ids, :3], record["jax__estimate__ext"][ids, :3])
        assert gap.max() <= 1e-4 * scene_radius, gap.max()


def test_every_rank_returns_the_same_bits(ranks):
    def strip(res):
        return {k: {n: x for n, x in v.items() if n not in ("seconds", "pairs")}
                for k, v in res.items()}

    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)) and a and isinstance(a[0], tuple):
            assert a == b, where
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)

    first = strip(ranks[0])
    for r, res in enumerate(ranks[1:], 1):
        same(first, strip(res), f"rank {r}")


@pytest.mark.slow
def test_record_is_the_jax_package_s(record):
    """The JAX package's mesh runs computed again on the record's inputs
    (this process's 8-device virtual CPU mesh, `tests/conftest.py`)."""
    inputs = ref.build_inputs()
    for k, v in inputs.items():
        np.testing.assert_allclose(record[k], v, rtol=1e-12, atol=0, err_msg=k)
    for k, v in ref.jax_outputs(inputs).items():
        np.testing.assert_allclose(record[f"jax__{k}"], v, rtol=1e-9, atol=1e-12, err_msg=k)
