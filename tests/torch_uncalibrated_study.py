"""How well the uncalibrated two-view path can recover focal lengths on the
ring scene, by look-at jitter: not a test (about 3 minutes on 6 threads).

    JAX_PLATFORMS=cpu python tests/torch_uncalibrated_study.py [--pairs 64] [--part jitter|minimal|jax]

On co-visible pairs of `pytheiasfm_tpu_torch.tools.ring_scene` (ring
distances 1-8, every other view) and their ground-truth correspondences:
  - `jitter`: for each look-at jitter box, whether the scene keeps its
    points in frame, the median focal error of the 8-point F fitted to all
    of a pair's correspondences (what the geometry allows), and of the best
    minimal sample of the port's uncalibrated RANSAC (what the path gives);
  - `minimal`: at the chosen jitter, the port's minimal-sample medians
    (focal, rotation) in f32 and f64 and over two generator seeds;
  - `jax`: the same through the JAX package's
    `estimate_uncalibrated_relative_pose` (f32, keys split from PRNGKey(0)).
"""

import argparse
import time

import numpy as np
import torch

from pytheiasfm_tpu_torch.ops import epipolar
from pytheiasfm_tpu_torch.ransac import engine, estimators
from pytheiasfm_tpu_torch.sfm.two_view import compute_resolution_scaled_threshold
from pytheiasfm_tpu_torch.tools import ring_scene as rs

JITTERS = [0.0, (0.2, 0.2, 0.5), (0.3, 0.3, 0.6), (0.3, 0.3, 0.7), (0.5, 0.5, 0.6),
           (0.8, 0.8, 0.6), (1.0, 1.0, 0.6)]
PP = np.array([rs.WIDTH / 2, rs.HEIGHT / 2])
THRESH = compute_resolution_scaled_threshold(6.0, rs.WIDTH, rs.HEIGHT) ** 2


def _problems(jitter, num_pairs):
    views, rots, track_ids = rs.ring_scene(look_jitter=jitter)
    pairs, p1, p2, mask = rs.covisible_correspondences(views, track_ids)
    step = max(1, len(pairs) // num_pairs)
    sel = np.arange(0, len(pairs), step)[:num_pairs]
    return [pairs[i] for i in sel], p1[sel] - PP, p2[sel] - PP, mask[sel], rots


def _params():
    return dict(failure_probability=1e-4, min_iterations=10, max_iterations=1000)


def _port(p1, p2, mask, dtype, seed):
    model, _ = estimators.estimate_uncalibrated_relative_pose(
        torch.Generator().manual_seed(seed), torch.tensor(p1, dtype=dtype),
        torch.tensor(p2, dtype=dtype), engine.RansacParameters(**_params()),
        mask=torch.tensor(mask), quality="mle",
        error_thresh=torch.full((len(p1),), THRESH, dtype=dtype))
    return (model.focal_length1.double().numpy(), model.focal_length2.double().numpy(),
            model.rotation.double().numpy())


def part_jitter(num_pairs):
    for jitter in JITTERS:
        try:
            pairs, p1, p2, mask, rots = _problems(jitter, num_pairs)
        except AssertionError:
            print(f"jitter {jitter}: points leave the frame")
            continue
        f1, f2 = [], []
        for a, b, m in zip(p1, p2, mask):
            F, _ = epipolar.eight_point_fundamental_matrix(torch.tensor(a[m]), torch.tensor(b[m]))
            x1, x2, _ = epipolar.focal_lengths_from_fundamental_matrix(F)
            f1.append(float(x1))
            f2.append(float(x2))
        ls = np.median(np.abs(np.concatenate([f1, f2]) / rs.FOCAL - 1))
        f1, f2, R = _port(p1, p2, mask, torch.float32, 0)
        focal, rot = rs.focal_and_rotation_errors(pairs, f1, f2, R, rots)
        print(f"jitter {jitter}: all correspondences' 8-point F: median focal error {ls:.4f}; "
              f"minimal samples (f32): median focal error {focal:.4f}, rotation {rot:.3f} deg",
              flush=True)


def part_minimal(num_pairs):
    pairs, p1, p2, mask, rots = _problems(rs.UNCALIBRATED_LOOK_JITTER, num_pairs)
    for dtype, seed in ((torch.float32, 0), (torch.float64, 0), (torch.float32, 1)):
        focal, rot = rs.focal_and_rotation_errors(pairs, *_port(p1, p2, mask, dtype, seed), rots)
        print(f"port, {dtype}, seed {seed}: median focal error {focal:.4f}, rotation "
              f"{rot:.3f} deg", flush=True)


def part_jax(num_pairs):
    import jax
    import jax.numpy as jnp

    from pytheiasfm_tpu.ransac import engine as jeng
    from pytheiasfm_tpu.ransac import estimators as jest

    pairs, p1, p2, mask, rots = _problems(rs.UNCALIBRATED_LOOK_JITTER, num_pairs)
    params = jeng.RansacParameters(**_params())
    run = jax.jit(jax.vmap(lambda k, a, b, m: jest.estimate_uncalibrated_relative_pose(
        k, a, b, params, mask=m, quality="mle", error_thresh=jnp.float32(THRESH))[0]))
    keys = jax.random.split(jax.random.PRNGKey(0), len(pairs))
    out = [run(keys[s:s + 16], *(jnp.asarray(x[s:s + 16], jnp.float32) for x in (p1, p2)),
               jnp.asarray(mask[s:s + 16])) for s in range(0, len(pairs), 16)]
    focal, rot = rs.focal_and_rotation_errors(
        pairs, *(np.concatenate([np.asarray(getattr(m, k)) for m in out])
                 for k in ("focal_length1", "focal_length2", "rotation")), rots)
    print(f"JAX, f32: median focal error {focal:.4f}, rotation {rot:.3f} deg", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=64)
    parser.add_argument("--part", choices=["jitter", "minimal", "jax"], nargs="+",
                        default=["jitter", "minimal", "jax"])
    args = parser.parse_args()
    torch.set_num_threads(6)
    for part in args.part:
        t0 = time.perf_counter()
        {"jitter": part_jitter, "minimal": part_minimal, "jax": part_jax}[part](args.pairs)
        print(f"({part}: {time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
