"""The JAX package's global-pose estimators at the size of `chip_smoke.py`
phase 15: the constants that phase holds the port to. Not a test: about a
quarter of an hour of CPU at full size.

    JAX_PLATFORMS=cpu python tests/torch_global_pose_reference.py \\
        [--views 553 --tracks 50000] [--out constants.json] [--study sdp|rounding|handoff]

On the port's `synthetic_global.build_scene` (553 views, 50,000 tracks,
seed 0 at the defaults; the same scene as the JAX package's, carried into
its containers as `test_torch_global_pose.scene` does), x64 on the CPU:

- steps 1-7 of the JAX estimator (`test_torch_global_pose.jax_steps`, its
  own methods in `estimate`'s order) at the default options, then with each
  run of the port's `tools.global_pose.ESTIMATOR_RUNS`: the other rotation
  estimators and the rigid subgraph through steps 1-7; the other position
  estimators on the default run's graph after step 6 (steps 1-6 do not
  depend on the position estimator). For each: views posed, edges after the
  orientation filter and after 1DSfM, the median rotation and position
  errors against ground truth (by the port's
  `tools.global_pose.ground_truth_errors`, so that both packages are
  measured by one function), and the views the rigid subgraph removes;
- `filter_view_graph_cycles_by_rotation` on the contaminated graph
  (`tools.global_pose.contaminate`): the edges removed;
- `ligt_positions` on the scene's observations (bearings by the port's
  `tools.global_pose.scene_bearings`) with the default run's orientations:
  the median position error;
- `estimate` (`rng_seed=0`) with the rigid subgraph and BATA positions,
  once with LAGRANGE_DUAL rotations and once with ROBUST_L1L2: views,
  tracks estimated, median and mean position error after Umeyama, the
  edges the orientation filter removed and the views the rigid subgraph
  removed, BA log lines.

`--study` runs instead what shows why LAGRANGE_DUAL fails at this size and
what its failed rotations leave: with `sdp`, its median rotation error
against ground truth (aligned to the MST start, as `estimate_rotations`
aligns it) after `SDPSolverOptions.max_iterations` of 200, 1,000 and 4,000
steps a rank level; with `rounding`, steps 1-7 with LAGRANGE_DUAL in the
JAX package on the scene with its relative rotations scaled by 1 + k·1e-15
(k = 0-3), then in the port on the CPU and, where there is one, on the
CUDA card: the edges after each filter and the medians; with `handoff`,
steps 5-6 crossed between the packages after LAGRANGE_DUAL (`_handoff`).

Each result prints as it is done, with its seconds; `--out` writes them all
as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--views", type=int, default=553)
    parser.add_argument("--tracks", type=int, default=50_000)
    parser.add_argument("--out", help="write the constants to this JSON file")
    parser.add_argument("--study", choices=("sdp", "rounding", "handoff"),
                        help="why LAGRANGE_DUAL fails at this size, instead of the constants")
    args = parser.parse_args(argv)
    _jax_cpu()
    import jax.numpy as jnp

    import test_torch_global_estimator as TG
    import test_torch_global_pose as S
    from pytheiasfm_tpu.global_pose import filters as jfilters
    from pytheiasfm_tpu.global_pose import position_estimator as jpos
    from pytheiasfm_tpu.sfm.global_estimator import GlobalReconstructionEstimator as JEstimator
    from pytheiasfm_tpu_torch.pipelines import synthetic_global as tsg
    from pytheiasfm_tpu_torch.tools import global_pose as gp

    size = dict(V=args.views, T=args.tracks)
    out = {"size": size, "runs": {}}

    def done(key, value, t0):
        value = dict(value, seconds=time.perf_counter() - t0)
        print(f"[{key}] {value}", flush=True)
        return value

    recon, graph, gt_positions, gt_aa, _ = S.scene("clean", **size)
    if args.study:
        out["study"] = _study(args.study, S, recon, graph, gt_aa, gt_positions, done)
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=1))
        return 0

    def summary(steps, positions=None):
        positions = steps["positions"] if positions is None else positions
        rot, pos = gp.ground_truth_errors(steps["orientations"], positions, gt_aa, gt_positions)
        return dict(views=len(positions), edges_orientation=len(steps["graph_orientation"].edges),
                    edges_1dsfm=len(steps["graph_1dsfm"].edges), rotation_deg=rot, position=pos,
                    rigid_removed_views=steps.get("rigid_removed_views"))

    t0 = time.perf_counter()
    base = S.jax_steps(recon, graph)
    out["runs"]["default"] = done("default", summary(base), t0)
    for label, kw in gp.ESTIMATOR_RUNS:
        t0 = time.perf_counter()
        options = S.jax_options(gp.estimator_options(**kw))
        if "position" in kw:
            positions = jpos.estimate_positions(
                base["graph_1dsfm"], base["orientations"],
                int(options.global_position_estimator_type))
            out["runs"][label] = done(label, summary(base, positions), t0)
        else:
            out["runs"][label] = done(label, summary(S.jax_steps(recon, graph, options)), t0)

    t0 = time.perf_counter()
    _, cgraph, _, _, _ = S.scene("contaminated", **size)
    edges = cgraph.num_edges()
    removed = jfilters.filter_view_graph_cycles_by_rotation(cgraph, 3.0)
    out["cycle_filter"] = done("cycle filter", dict(edges=edges, removed=removed), t0)

    t0 = time.perf_counter()
    precon, _, _ = tsg.build_scene(**size)
    obs_view, obs_track, bearings = gp.scene_bearings(precon)
    V = precon.num_views()
    orientations = base["orientations"]
    orient = np.stack([orientations[v] for v in range(V)])
    c = np.asarray(jpos.ligt_positions(jnp.asarray(obs_view), jnp.asarray(obs_track),
                                       jnp.asarray(bearings), jnp.asarray(orient), V,
                                       precon.num_tracks()))
    _, pos = gp.ground_truth_errors(orientations, dict(enumerate(c)), gt_aa, gt_positions)
    out["ligt"] = done("LiGT", dict(observations=len(obs_view), position=pos), t0)

    for key, rotation in (("estimate", "LAGRANGE_DUAL"), ("estimate robust", None)):
        t0 = time.perf_counter()
        jrecon, jgraph, _, _, _ = S.scene("clean", **size)
        options = S.jax_options(gp.estimator_options(rotation, "BATA", True, rng_seed=0))
        removed = {}
        kept = {name: getattr(jfilters, name) for name in (
            "filter_view_pairs_from_orientation", "extract_maximally_parallel_rigid_subgraph")}

        def keep(name):
            def wrapped(*a, **k):
                removed[name] = kept[name](*a, **k)
                return removed[name]
            return wrapped

        for name in kept:
            setattr(jfilters, name, keep(name))
        try:
            with TG.jax_ba_log() as lines:
                result = JEstimator(options).estimate(jgraph, jrecon)
        finally:
            for name, fn in kept.items():
                setattr(jfilters, name, fn)
        ids, err = tsg.position_errors(jrecon, gt_positions)
        out[key] = done(key, dict(
            views=len(ids), estimated_tracks=len(result.estimated_tracks),
            median_pos_err=float(np.median(err)), mean_pos_err=float(np.mean(err)),
            orientation_filter_removed=removed["filter_view_pairs_from_orientation"],
            rigid_removed_views=removed["extract_maximally_parallel_rigid_subgraph"],
            ba_log=lines), t0)

    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


def _study(kind, S, recon, graph, gt_aa, gt_positions, done):
    """LAGRANGE_DUAL at more SDP steps (`sdp`), or steps 1-7 with it under
    rounding-level changes and in the port (`rounding`)."""
    import copy

    import jax.numpy as jnp
    import torch

    from pytheiasfm_tpu.global_pose import rotation_estimator as jrot
    from pytheiasfm_tpu.math.sdp import SDPSolverOptions
    from pytheiasfm_tpu.ops import rotation as jrotops
    from pytheiasfm_tpu_torch import convert
    from pytheiasfm_tpu_torch.tools import global_pose as gp

    out = {}
    if kind == "sdp":
        v1, v2, rel, _, _ = graph.edge_arrays()
        init = jrot.orientations_from_maximum_spanning_tree(graph)
        V = recon.num_views()
        start = jnp.asarray(np.stack([init[v] for v in range(V)]))
        for iters in (200, 1000, 4000):
            t0 = time.perf_counter()
            aa, lam = jrot.lagrange_dual_rotation_averaging(
                jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(rel), V,
                SDPSolverOptions(max_iterations=iters))
            aa = dict(enumerate(np.asarray(jrotops.align_orientations(start, aa))))
            rot, _ = gp.ground_truth_errors(aa, aa, gt_aa, gt_positions)
            out[f"sdp {iters}"] = done(f"LAGRANGE_DUAL, {iters} SDP steps",
                                       dict(rotation_deg=rot, certificate=float(lam)), t0)
        return out

    def counts(orientations, positions, edges_orientation, edges_1dsfm):
        rot, pos = gp.ground_truth_errors(orientations, positions, gt_aa, gt_positions)
        return dict(views=len(positions), edges_orientation=edges_orientation,
                    edges_1dsfm=edges_1dsfm, rotation_deg=rot, position=pos)

    options = gp.estimator_options("LAGRANGE_DUAL")
    if kind == "handoff":
        return _handoff(S, recon, graph, options, done)
    for k in range(4):
        t0 = time.perf_counter()
        g = copy.deepcopy(graph)
        for info in g.edges.values():
            info.rotation_2 = info.rotation_2 * (1.0 + k * 1e-15)
        steps = S.jax_steps(recon, g, S.jax_options(options))
        out[f"scaled {k}"] = done(
            f"JAX steps 1-7, LAGRANGE_DUAL, rotations x (1 + {k}e-15)",
            counts(steps["orientations"], steps["positions"],
                   len(steps["graph_orientation"].edges), len(steps["graph_1dsfm"].edges)), t0)
    for device in ["cpu"] + (["cuda"] if torch.cuda.is_available() else []):
        t0 = time.perf_counter()
        res = gp.run_global_pose(convert.view_graph(graph), convert.reconstruction(recon),
                                 options, device=device)
        out[f"port {device}"] = done(
            f"port steps 1-7 on {device}, LAGRANGE_DUAL",
            counts(res.orientations, res.positions, len(res.edges["orientation filter"]),
                   len(res.edges["1DSfM"])), t0)
    return out


def _handoff(S, recon, graph, options, done):
    """Steps 5-6 after LAGRANGE_DUAL, crossed: each package's step 5 and
    step 6 from JAX's step-4 graph with JAX's orientations, with the port's
    (CPU and card) and with JAX's own under its relative rotations scaled by
    1 + 1e-15. For each: the refined directions against JAX's own step 5
    (largest angle between the lines, edges over 1e-6 rad, sign flips on
    edges where one sign has a majority of points in front and on the
    others) and the edges 1DSfM removes against JAX's own set."""
    import copy

    import torch

    from pytheiasfm_tpu.global_pose import filters as jfilters
    from pytheiasfm_tpu.global_pose import rotation_estimator as jrot
    from pytheiasfm_tpu.sfm import global_estimator as jge
    from pytheiasfm_tpu_torch import convert
    from pytheiasfm_tpu_torch.global_pose import filters as tfilters
    from pytheiasfm_tpu_torch.global_pose import rotation_estimator as trot
    from pytheiasfm_tpu_torch.ops import rotation as trotops
    from pytheiasfm_tpu_torch.ops import triangulation as ttri
    from pytheiasfm_tpu_torch.sfm.global_estimator import GlobalReconstructionEstimator

    jopt = S.jax_options(options)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    out = {}
    t0 = time.perf_counter()
    ref = S.jax_steps(recon, graph, jopt)
    kept = set(ref["orientations_after_filter"])
    jorient = {v: np.asarray(ref["orientations_after_filter"][v]) for v in kept}
    jremoved = ref["removed_1dsfm"]
    out["jax"] = done("JAX steps 1-7, LAGRANGE_DUAL", dict(
        edges_orientation=len(ref["graph_orientation"].edges), removed_1dsfm=len(jremoved)), t0)

    # Orientations from step 3 on the step-1 graph: the port's on each
    # device, and JAX's own with its relative rotations scaled.
    orients = {}
    for device in devices:
        t0 = time.perf_counter()
        g = convert.view_graph(ref["graph_initial"])
        o = trot.estimate_rotations(g, int(options.global_rotation_estimator_type),
                                    device=device)
        filtered = copy.deepcopy(g)
        tfilters.filter_view_pairs_from_orientation(
            filtered, o, options.rotation_filtering_max_difference_degrees, device=device)
        orients[f"port {device}"] = {v: np.asarray(o[v]) for v in kept}
        out[f"rotations port {device}"] = done(f"port step 3 on {device}", dict(
            max_rad_from_jax=S.rotation_angle_diff(orients[f"port {device}"], jorient),
            same_orientation_filter=set(filtered.edges) == set(ref["graph_orientation"].edges)),
            t0)
    t0 = time.perf_counter()
    g = copy.deepcopy(ref["graph_initial"])
    for info in g.edges.values():
        info.rotation_2 = info.rotation_2 * (1.0 + 1e-15)
    o = jrot.estimate_rotations(g, int(jopt.global_rotation_estimator_type))
    orients["jax scaled"] = {v: np.asarray(o[v]) for v in kept}
    out["rotations jax scaled"] = done("JAX step 3, relative rotations x (1 + 1e-15)", dict(
        max_rad_from_jax=S.rotation_angle_diff(orients["jax scaled"], jorient)), t0)

    def step5(who, orient):
        if who == "jax":
            g = copy.deepcopy(ref["graph_orientation"])
            jge.GlobalReconstructionEstimator(jopt)._optimize_pairwise_translations(
                g, dict(orient), copy.deepcopy(ref["recon"]))
            return g
        g = convert.view_graph(ref["graph_orientation"])
        GlobalReconstructionEstimator(options, device=who)._optimize_pairwise_translations(
            g, dict(orient), convert.reconstruction(ref["recon"]))
        return g

    def step6(who, g, orient):
        g = copy.deepcopy(g)
        before = set(g.edges)
        kw = dict(num_iterations=options.translation_filtering_num_iterations,
                  translation_projection_tolerance=options.translation_filtering_projection_tolerance,
                  rng=np.random.default_rng(options.rng_seed))
        if who == "jax":
            jfilters.filter_view_pairs_from_relative_translation(g, dict(orient), **kw)
        else:
            tfilters.filter_view_pairs_from_relative_translation(g, dict(orient), device=who,
                                                                 **kw)
        return before - set(g.edges)

    # The edges of JAX's step 5 where one sign of its direction puts a
    # majority of the shared points in front of both cameras; elsewhere the
    # sign is the eigen-solver's (`test_torch_global_pose.py`,
    # `test_pairwise_translations_where_no_sign_has_a_majority`).
    rot1, rot2, x1, x2, mask, _ = (torch.as_tensor(a) for a in ref["pairwise"]["inputs"])
    t = torch.as_tensor(ref["pairwise"]["outputs"][0])
    R_rel = trotops.angle_axis_to_rotation_matrix(rot2) @ trotops.angle_axis_to_rotation_matrix(
        rot1).mT
    majority = torch.zeros(len(t), dtype=torch.bool)
    for sign in (1.0, -1.0):
        front = ttri.is_triangulated_point_in_front_of_cameras(x1, x2, R_rel[:, None],
                                                               sign * t[:, None])
        majority |= (front & mask).sum(-1) > mask.sum(-1) // 2
    keys = [k for k in ref["graph_orientation"].edges if k[0] in kept and k[1] in kept]
    majority = majority.numpy()
    out["majority"] = done("JAX step 5: edges with a majority sign", dict(
        edges=len(keys), with_majority=int(majority.sum())), time.perf_counter())

    def directions(g):
        a = np.stack([np.asarray(g.get_edge(*k).position_2) for k in keys])
        b = np.stack([np.asarray(ref["graph_pairwise"].get_edge(*k).position_2) for k in keys])
        cos = np.clip(np.sum(a * b, -1) / np.linalg.norm(a, axis=-1)
                      / np.linalg.norm(b, axis=-1), -1.0, 1.0)
        ang = np.arccos(np.abs(cos))
        return dict(max_rad=float(ang.max()), over_1e_6=int(np.sum(ang > 1e-6)),
                    sign_flips_with_majority=int(np.sum((cos < 0) & majority)),
                    sign_flips_without=int(np.sum((cos < 0) & ~majority)))

    rows = [("jax", "jax", "jax")] + [(d, d, "jax") for d in devices] + [
        ("jax", devices[0], "jax")] + [("jax", "jax", name) for name in orients] + [
        (d, d, f"port {d}") for d in devices]
    for s5, s6, who in rows:
        t0 = time.perf_counter()
        orient = jorient if who == "jax" else orients[who]
        g = step5(s5, orient)
        removed = step6(s6, g, orient)
        label = f"step 5 {s5}, step 6 {s6}, orientations {who}"
        out[label] = done(label, dict(
            directions=directions(g), removed=len(removed),
            removed_not_in_jax=len(removed - jremoved), jax_not_removed=len(jremoved - removed)),
            t0)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
