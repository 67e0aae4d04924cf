"""The JAX package's side of the port's remaining minimal solvers: the
record that `tests/test_torch_focal_radial.py` compares with, and the
constants of `chip_smoke.py` phase 16. Not a test.

    JAX_PLATFORMS=cpu python tests/torch_minimal_solvers_reference.py record
    JAX_PLATFORMS=cpu python tests/torch_minimal_solvers_reference.py p4pfr-share
    JAX_PLATFORMS=cpu python tests/torch_minimal_solvers_reference.py phase16 [--out c.json]

- `record` writes `tests/data/torch_focal_radial_jax.npz`,
  `torch_partial_rotation_jax.npz` and `torch_generalized_pose_jax.npz`:
  the JAX package's solvers on the inputs of those test modules (x64;
  about 3 minutes, the JAX traces; each module's `slow` test computes its
  record again).
- `p4pfr-share` prints the share of runs in which the JAX estimator
  `estimate_radial_dist_uncalibrated_absolute_pose` meets the JAX test's
  bars on the 4 scenes of `test_torch_robust_estimators_extra.p4pfr_scenes`
  over `PRNGKey(0..7)`.
- `phase16` runs the JAX estimators and minimal solvers on the problems and
  samples of the port's `tools.minimal_solvers` (f32, as on the card) and
  prints the constants `chip_smoke.py` holds phase 16 to: every problem
  of each estimator, pooled over the keys `DRAWS[name]` (tens of minutes
  of CPU: on the chip machine's CPU, never on a small host; `--subset N`
  runs the first N, `--key K` starts the keys at K, `--only` runs some of
  them).
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

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def record():
    jax.config.update("jax_enable_x64", True)
    import test_torch_focal_radial
    import test_torch_generalized_pose
    import test_torch_partial_rotation

    for module in (test_torch_focal_radial, test_torch_partial_rotation,
                   test_torch_generalized_pose):
        t0 = time.perf_counter()
        module.save_record()
        print(f"wrote {module.RECORD} in {time.perf_counter() - t0:.1f} s", flush=True)


def p4pfr_share():
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pytheiasfm_tpu.ransac import engine
    from pytheiasfm_tpu.ransac.estimators import (
        estimate_radial_dist_uncalibrated_absolute_pose,
    )
    import test_torch_robust_estimators_extra as E

    params = engine.RansacParameters(error_thresh=4.0**2, max_iterations=256,
                                     min_iterations=256)
    fn = jax.jit(lambda key, uv, X: estimate_radial_dist_uncalibrated_absolute_pose(
        key, uv, X, params, min_focal_length=500.0, max_focal_length=2000.0))
    met = []
    for i, (uv, X, _, _) in enumerate(E.p4pfr_scenes()):
        n = uv.shape[0]
        for key in range(8):
            model, summary = fn(jax.random.PRNGKey(key), jnp.asarray(uv), jnp.asarray(X))
            met.append(int(summary.num_inliers) >= n - 8 - 8
                       and abs(float(model.focal_length) - 1000.0) <= 100.0)
        print(f"scene {i}: {met[-8:]}", flush=True)
    print(f"JAX_P4PFR_SHARE = {sum(met)} / {len(met)}")


# The JAX CPU runs of phase 16 cover these subsets: the first problems of
# each estimator (all of them) and the first samples of each solver.
ESTIMATOR_SUBSET = 553
SOLVER_SUBSET = {"radial_homography": 256}
SOLVER_SUBSET_DEFAULT = 1024


def phase16(key=0, subset=ESTIMATOR_SUBSET, only=None):
    """The JAX package's estimators (f32, vmapped over chunks of 8
    problems, keys split from PRNGKey(key + draw) for each of the
    `DRAWS[name]` draws) on the first `subset` problems of
    `tools.minimal_solvers.build_problems`, at the port's ITERATIONS: the
    medians and solved share of `estimator_errors` pooled over the draws
    (each draw's printed too); and each JAX minimal solver (f32) on the
    first samples of `minimal_samples(name, 16384)`: the share
    `recovered`. `only` names the estimators and solvers to run (all by
    default)."""
    import jax.numpy as jnp

    from pytheiasfm_tpu.ops import (
        focal_radial, generalized_pose, orthographic, partial_rotation, radial_homography,
    )
    from pytheiasfm_tpu.ransac import engine, estimators as jest
    from pytheiasfm_tpu_torch.tools import minimal_solvers as M

    fns = {
        "p4pf": jest.estimate_uncalibrated_absolute_pose,
        "p4pfr": jest.estimate_radial_dist_uncalibrated_absolute_pose,
        "similarity": jest.estimate_similarity_transformation_2d_3d,
        "rigid": jest.estimate_rigid_transformation_2d_3d,
        "plane": jest.estimate_dominant_plane_from_points,
        "radial_homography": jest.estimate_radial_distortion_homography,
    }
    problems = M.build_problems()
    out = {"estimators": {}, "solvers": {},
           "solver_samples": dict(SOLVER_SUBSET, default=SOLVER_SUBSET_DEFAULT)}
    for name in M.ESTIMATORS:
        if only and name not in only:
            continue
        prob = problems[name]
        count = min(subset, prob["mask"].shape[0])
        _, arrays = M.estimator_inputs(name, prob)
        n = M.ITERATIONS[name]
        params = engine.RansacParameters(max_iterations=n, min_iterations=n)
        fn = fns[name]
        run = jax.jit(jax.vmap(lambda k, m, t, *a, fn=fn, params=params: fn(
            k, *a, params, mask=m, error_thresh=t)))
        errs = []
        for draw in range(M.DRAWS.get(name, 1)):
            t0 = time.perf_counter()
            keys = jax.random.split(jax.random.PRNGKey(key + draw), subset)
            models, nums = [], []
            for s0 in range(0, count, 8):
                sl = slice(s0, s0 + 8)
                model, summary = run(keys[:count][sl], jnp.asarray(prob["mask"][sl]),
                                     jnp.asarray(prob["thresh"][sl], jnp.float32),
                                     *(jnp.asarray(a[sl], jnp.float32) for a in arrays))
                models.append(model)
                nums.append(np.asarray(summary.num_inliers))
            model = type(models[0])(*(np.concatenate([np.asarray(getattr(m, f)) for m in models])
                                      for f in models[0]._fields))
            errs.append(M.estimator_errors(name, model, np.concatenate(nums), problems,
                                           rows=slice(0, count)))
            print(f"[{name} key {key + draw}] {count} problems, "
                  f"{time.perf_counter() - t0:.1f} s: {M.summarize(errs[-1])}", flush=True)
        err = M.summarize(M.pool(errs))
        out["estimators"][name] = err
        print(f"[{name}] pooled over {len(errs)} draws: {err}", flush=True)
    jmods = {"focal_radial": focal_radial, "radial_homography": radial_homography,
             "generalized_pose": generalized_pose, "orthographic": orthographic,
             "partial_rotation": partial_rotation}
    for name, (module, fn, kw, _) in M.SOLVERS.items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        count = SOLVER_SUBSET.get(name, SOLVER_SUBSET_DEFAULT)
        inputs, gt = M.minimal_samples(name, 16384)
        jfn = getattr(jmods[module.__name__.rsplit(".", 1)[1]], fn)
        sub = [a if a.ndim == 1 else a[:count] for a in inputs]
        res = [np.asarray(x) for x in jfn(*(jnp.asarray(a, jnp.float32) for a in sub), **kw)]
        share = float(np.mean(M.recovered(name, res, {k: v[:count] for k, v in gt.items()})))
        out["solvers"][name] = share
        print(f"[{name}] {count} samples, {time.perf_counter() - t0:.1f} s: recovered {share!r}",
              flush=True)
    print("JAX_CPU_MINIMAL = " + json.dumps(out, indent=1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["record", "p4pfr-share", "phase16"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--key", type=int, default=0,
                    help="phase16: the estimators' first PRNGKey")
    ap.add_argument("--subset", type=int, default=ESTIMATOR_SUBSET,
                    help="phase16: the estimators' first problems")
    ap.add_argument("--only", nargs="*", default=None, help="phase16: estimators / solvers")
    args = ap.parse_args(argv)
    if args.what == "record":
        record()
    elif args.what == "p4pfr-share":
        p4pfr_share()
    else:
        out = phase16(args.key, args.subset, args.only)
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
