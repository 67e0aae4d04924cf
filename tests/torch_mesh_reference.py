"""The JAX package's side of the port's device mesh: the inputs of the
mesh cases of `tests/test_torch_parallel.py` and `tests/test_torch_mesh_sfm.py`
and the JAX package's outputs on them, each run on its own 8-device (or, for
the two-process case, 4-device) virtual CPU mesh. Not a test.

    JAX_PLATFORMS=cpu python tests/torch_mesh_reference.py record

writes `tests/data/torch_mesh_jax.npz` (x64; about a minute, the JAX traces);
`test_torch_mesh_sfm.test_record_is_the_jax_package_s` (`slow`) computes it
again. The cases are the JAX tests of `tests/test_multichip.py` and
`tests/test_multihost.py`, with edge, track and observation counts that
neither 4 nor 8 divides where the JAX function pads (the JAX package's
`shard_map` functions need a divisible axis: their inputs are padded with
zero rows here, which changes no sum).
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
RECORD = HERE / "data" / "torch_mesh_jax.npz"

if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Sizes of the cases (the JAX tests' where 4 and 8 do not divide them).
SEGSUM = dict(O=4095, S=37)
BLOCKS = dict(O=2047, V=12, T=100)
FLAT = dict(V=10, T=121, seed=3, iterations=5)
MATCHER = dict(pairs=10, n=128, d=32, ratio=0.9)
ENTRY_DENSE = dict(views=10, tracks=121, seed=3, iterations=10)
ENTRY_ITERATIVE = dict(views=10, tracks=121, seed=5, iterations=30)
ESTIMATE = dict(V=24, T=900, obs_per_track=6, neighborhood=8, seed=4, min_shared_tracks=10,
                iterations=30)
GRAPH = dict(views=30, edges=180)  # less its last edge: 179
TRIANGULATION = dict(views=8, tracks=150, seed=3)
DENSE = dict(T=64, iterations=15)
TWO_PROCESS = dict(T=64, seed=7, iterations=8)
# The flat kernel's arguments in order (`__graft_entry__._ARG_ORDER`).
FLAT_ARGS = ("extrinsics", "intrinsics", "points", "view_group", "group_model_idx", "obs_view",
             "obs_track", "obs_uv", "obs_sqrt_info", "obs_mask", "camera_free", "point_free",
             "intrinsics_free", "track_ref_view", "track_bearing")


def perturbed_entry_scene(module, views, tracks, seed, free_intrinsics):
    """`random_reconstruction` of `module` (either package's
    `utils.synthetic`) with views 2.. moved by 0.01 and the points by 0.02
    (the JAX tests' perturbation, drawn from `default_rng(42)`); with
    `free_intrinsics`, one shared intrinsics group 3% off in focal length."""
    rng = np.random.default_rng(42)
    r = module.random_reconstruction(num_views=views, num_tracks=tracks, seed=seed)
    r.view_extrinsics[2:] += rng.standard_normal((views - 2, 6)) * 0.01
    if free_intrinsics:
        r.view_group[:] = 0
        r.intrinsics = r.intrinsics[:1]
        r.group_model = r.group_model[:1]
        r.intrinsics[0, 0] *= 1.03
    else:
        r.points[:, :3] += 0.02
    return r


def triangulation_scene(module):
    r = module.random_reconstruction(num_views=TRIANGULATION["views"],
                                     num_tracks=TRIANGULATION["tracks"],
                                     seed=TRIANGULATION["seed"])
    r.track_estimated[:] = False
    r.points[:] = 0.0
    return r


def build_inputs():
    """Every case's inputs as numpy arrays (keys `case__name`)."""
    import __graft_entry__ as ge
    from test_dense_schur import _make_problem
    from test_global_pose import make_scene

    out = {}
    rng = np.random.default_rng(42)
    O, S = SEGSUM["O"], SEGSUM["S"]
    out["segsum__values"] = rng.normal(size=(O, 5))
    out["segsum__ids"] = rng.integers(0, S, size=O).astype(np.int64)

    rng = np.random.default_rng(42)
    O, V, T = BLOCKS["O"], BLOCKS["V"], BLOCKS["T"]
    out["blocks__Jc"] = rng.normal(size=(O, 2, 6))
    out["blocks__Jp"] = rng.normal(size=(O, 2, 3))
    out["blocks__r"] = rng.normal(size=(O, 2))
    out["blocks__ov"] = rng.integers(0, V, size=O).astype(np.int64)
    out["blocks__ot"] = rng.integers(0, T, size=O).astype(np.int64)

    prob = ge._synthetic_ba_problem(V=FLAT["V"], T=FLAT["T"], seed=FLAT["seed"],
                                    dtype=np.float64)
    assert tuple(ge._ARG_ORDER) == FLAT_ARGS
    for k in FLAT_ARGS:
        out[f"flat__{k}"] = np.asarray(prob[k])

    rng = np.random.default_rng(42)
    P, n, d = MATCHER["pairs"], MATCHER["n"], MATCHER["d"]
    out["matcher__d1"] = rng.normal(size=(P, n, d)).astype(np.float32)
    out["matcher__d2"] = rng.normal(size=(P, n, d)).astype(np.float32)

    for name, noise in (("rotations", (0.5, 0.01)), ("positions", (0.0, 0.02))):
        rng = np.random.default_rng(42)
        gt_aa, gt_pos, graph = make_scene(GRAPH["views"], GRAPH["edges"], *noise, rng)
        keys = sorted(graph.edges)[:-1]
        out[f"{name}__edges"] = np.asarray(keys, np.int64)
        out[f"{name}__rotation_2"] = np.stack([graph.edges[k].rotation_2 for k in keys])
        out[f"{name}__position_2"] = np.stack([graph.edges[k].position_2 for k in keys])
        out[f"{name}__matches"] = np.asarray(
            [graph.edges[k].num_verified_matches for k in keys], np.int64)
        out[f"{name}__gt_aa"] = gt_aa
        out[f"{name}__gt_pos"] = gt_pos

    p = _make_problem(np.random.default_rng(42), T=DENSE["T"])
    for k, v in p.items():
        out[f"dense__{k}"] = np.asarray(v)
    p = _make_problem(np.random.default_rng(TWO_PROCESS["seed"]), T=TWO_PROCESS["T"],
                      dtype=np.float64)
    for k, v in p.items():
        out[f"two_process__{k}"] = np.asarray(v)
    return out


def problem(inputs, case):
    """The `_make_problem` dict of a dense case back from the arrays."""
    p = {k.split("__", 1)[1]: v for k, v in inputs.items() if k.startswith(case + "__")}
    for k in ("V", "T", "L"):
        p[k] = int(p[k])
    return p


def _dense_jax(p, iterations, mesh):
    import jax.numpy as jnp

    from pytheiasfm_tpu.ba import BundleAdjustmentOptions, bundle_adjust_dense
    from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as M

    V, T, L = p["V"], p["T"], p["L"]
    ext, _, pts, s = bundle_adjust_dense(
        jnp.asarray(p["ext"]), jnp.asarray(p["intr"]), jnp.asarray(p["pts"]),
        jnp.asarray(p["view_group"]), jnp.asarray(p["group_model_idx"]),
        jnp.asarray(p["track_views"]), jnp.asarray(p["uv"].reshape(T, L, 2)),
        jnp.asarray(p["info"].reshape(T, L, 2)), jnp.asarray(p["mask"].reshape(T, L)),
        jnp.asarray(p["cam_free"]), jnp.asarray(p["pt_free"]),
        present_models=(int(M.PINHOLE),), num_views=V, num_tracks=T, max_track_len=L,
        num_groups=1, options=BundleAdjustmentOptions(max_num_iterations=iterations), mesh=mesh,
    )
    return np.asarray(ext), np.asarray(pts), float(s.final_cost)


def jax_outputs(inputs):
    """The JAX package's mesh runs on `inputs` (keys `case__name`)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from pytheiasfm_tpu import global_pose as gp
    from pytheiasfm_tpu.ba import BundleAdjustmentOptions, bundle_adjust
    from pytheiasfm_tpu.ba.entry import bundle_adjust_partial_reconstruction
    from pytheiasfm_tpu.matching.brute_force import match_descriptors_batch
    from pytheiasfm_tpu.models.intrinsics import CameraIntrinsicsModelType as M
    from pytheiasfm_tpu.models.intrinsics import OptimizeIntrinsicsType as OI
    from pytheiasfm_tpu.parallel import make_mesh, pad_to_multiple
    from pytheiasfm_tpu.parallel.distributed import (
        distributed_normal_equation_blocks,
        sharded_segment_sum,
    )
    from pytheiasfm_tpu.pipelines import synthetic_global as sg
    from pytheiasfm_tpu.sfm.estimator_options import (
        ReconstructionEstimatorOptions,
        ReconstructionEstimatorType,
    )
    from pytheiasfm_tpu.sfm.reconstruction_estimator import create_reconstruction_estimator
    from pytheiasfm_tpu.sfm.track_estimator import TrackEstimatorOptions, estimate_all_tracks
    from pytheiasfm_tpu.sfm.view_graph import TwoViewInfo, ViewGraph
    from pytheiasfm_tpu.utils import synthetic as jsyn

    mesh = make_mesh(8)
    shard = NamedSharding(mesh, PS("data"))
    out = {}

    def padded(*names):
        return [jnp.asarray(pad_to_multiple(inputs[n], 8)[0]) for n in names]

    v, ids = padded("segsum__values", "segsum__ids")
    out["segsum__out"] = np.asarray(sharded_segment_sum(v, ids.astype(jnp.int32), SEGSUM["S"],
                                                        mesh))
    Jc, Jp, r, ov, ot = padded(*(f"blocks__{k}" for k in ("Jc", "Jp", "r", "ov", "ot")))
    for name, x in zip(("U", "Vt", "bc", "bp"), distributed_normal_equation_blocks(
            Jc, Jp, r, ov.astype(jnp.int32), ot.astype(jnp.int32), BLOCKS["V"], BLOCKS["T"],
            mesh)):
        out[f"blocks__{name}"] = np.asarray(x)

    # The flat kernel on observation-sharded inputs (test_multichip.py:56).
    obs_names = ("obs_view", "obs_track", "obs_uv", "obs_sqrt_info", "obs_mask")
    O = len(inputs["flat__obs_view"])
    args = []
    for k in FLAT_ARGS:
        a = inputs[f"flat__{k}"]
        if k in obs_names:
            a = pad_to_multiple(a, 8)[0]
            if k == "obs_mask":
                a = a.copy()
                a[O:] = False
            args.append(jax.device_put(jnp.asarray(a), shard))
        else:
            args.append(jnp.asarray(a))
    options = BundleAdjustmentOptions(max_num_iterations=FLAT["iterations"],
                                      function_tolerance=0.0)

    def step(*a):
        ext, _, pts, s = bundle_adjust(*a, present_models=(int(M.PINHOLE),),
                                       num_views=FLAT["V"], num_tracks=FLAT["T"], num_groups=1,
                                       options=options)
        return ext, pts, s.final_cost

    ext, pts, cost = jax.jit(step)(*args)
    out["flat__ext"], out["flat__pts"], out["flat__cost"] = (
        np.asarray(ext), np.asarray(pts), np.asarray(float(cost)))

    # The pair-sharded matcher (test_multichip.py:106), at its default bf16.
    P, n = MATCHER["pairs"], MATCHER["n"]
    d1, d2 = padded("matcher__d1", "matcher__d2")
    m = jnp.ones(d1.shape[:2], bool).at[P:].set(False)
    idx, dist = match_descriptors_batch(
        jax.device_put(d1, shard), jax.device_put(d2, shard), jax.device_put(m, shard),
        jax.device_put(m, shard), jnp.asarray(MATCHER["ratio"], jnp.float32))
    out["matcher__idx"], out["matcher__dist"] = np.asarray(idx)[:P], np.asarray(dist)[:P]

    # The BA entry on the mesh: dense (calibrated) and iterative (free focal).
    for case, free in (("entry_dense", False), ("entry_iterative", True)):
        cfg = ENTRY_DENSE if case == "entry_dense" else ENTRY_ITERATIVE
        r = perturbed_entry_scene(jsyn, cfg["views"], cfg["tracks"], cfg["seed"], free)
        base = BundleAdjustmentOptions(
            max_num_iterations=cfg["iterations"],
            intrinsics_to_optimize=OI.FOCAL_LENGTH if free else OI.NONE, mesh=mesh)
        s = bundle_adjust_partial_reconstruction(
            base, list(range(2, cfg["views"])), list(range(cfg["tracks"])), r,
            dtype=np.float64)
        out[f"{case}__ext"] = r.view_extrinsics.copy()
        out[f"{case}__points"] = r.points.copy()
        out[f"{case}__intrinsics"] = r.intrinsics.copy()
        out[f"{case}__cost"] = np.asarray(float(s.final_cost))

    # `estimate` on the 24-view scene (test_multichip.py:202).
    cfg = ESTIMATE
    recon, graph, gt = sg.build_scene(**{k: v for k, v in cfg.items() if k != "iterations"})
    summary = create_reconstruction_estimator(ReconstructionEstimatorOptions(
        reconstruction_estimator_type=ReconstructionEstimatorType.GLOBAL, mesh=mesh,
        max_num_iterations=cfg["iterations"])).estimate(graph, recon)
    out["estimate__success"] = np.asarray(bool(summary.success))
    out["estimate__views"] = np.asarray(sorted(summary.estimated_views), np.int64)
    out["estimate__tracks"] = np.asarray(sorted(summary.estimated_tracks), np.int64)
    out["estimate__ext"] = recon.view_extrinsics.copy()

    # Rotation averaging and LUD on the sharded edge axis.
    for name in ("rotations", "positions"):
        g = ViewGraph()
        for (i, j), rot, pos, nm in zip(inputs[f"{name}__edges"], inputs[f"{name}__rotation_2"],
                                        inputs[f"{name}__position_2"],
                                        inputs[f"{name}__matches"]):
            g.add_edge(int(i), int(j), TwoViewInfo(rotation_2=rot, position_2=pos,
                                                   num_verified_matches=int(nm)))
        if name == "rotations":
            est = gp.estimate_rotations(g, mesh=mesh)
        else:
            gt_aa = inputs["positions__gt_aa"]
            est = gp.estimate_positions(g, {i: gt_aa[i] for i in range(len(gt_aa))}, mesh=mesh)
        out[f"{name}__out"] = np.stack([est[v] for v in range(GRAPH["views"])])

    # Track-sharded triangulation (f64).
    r = triangulation_scene(jsyn)
    s = estimate_all_tracks(r, TrackEstimatorOptions(mesh=mesh), dtype=np.float64)
    out["triangulation__points"] = r.points.copy()
    out["triangulation__estimated"] = np.asarray(sorted(s.estimated_tracks), np.int64)

    # The dense Schur's explicit collectives; the two-process case's dense
    # BA on its 4-device global mesh.
    ext, pts, cost = _dense_jax(problem(inputs, "dense"), DENSE["iterations"], mesh)
    out["dense__ext_out"], out["dense__pts_out"], out["dense__cost"] = ext, pts, np.asarray(cost)
    ext, pts, cost = _dense_jax(problem(inputs, "two_process"), TWO_PROCESS["iterations"],
                                make_mesh(4))
    out["two_process__ext_out"], out["two_process__cost"] = ext, np.asarray(cost)
    return out


def record(path=RECORD):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    assert jax.device_count() >= 8, "needs the 8-device virtual CPU mesh"
    t0 = time.perf_counter()
    inputs = build_inputs()
    outputs = jax_outputs(inputs)
    np.savez_compressed(path, **inputs, **{f"jax__{k}": v for k, v in outputs.items()})
    print(f"wrote {path} in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["record"]:
        sys.exit(__doc__)
    record()
