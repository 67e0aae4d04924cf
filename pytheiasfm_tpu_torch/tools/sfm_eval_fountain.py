"""Feature tracks from a file -> reconstruction -> ATE, the user's command.

The port's form of the repository's `tools/sfm_eval_fountain.py`: a thin
command over `pipelines.fountain.evaluate` (verification of every
co-observing pair, the chosen estimator, the Sim(3)-aligned camera-centre
error against the ground truth), on the CUDA card unless `--device cpu` is
given. The defaults are the reference's fountain-11 files
(`fountain.DEFAULT_FOUNTAIN` / `DEFAULT_GT`); `--tracks` and `--gt` take
any pair of Theia `.recon` files, such as the 553-view scene of
`tools.file_scene`:

    python -m pytheiasfm_tpu_torch.tools.sfm_eval_fountain
        [--tracks tracks.recon --gt gt.recon]
        [--estimator global|incremental|hybrid] [--max-tracks N]
        [--seed 0] [--repeat K] [--device cuda|cpu]

Prints one JSON line with the JAX command's keys. `--repeat 2` runs the
pipeline twice and reports the second run, the first one's total time
beside it (`t_total_first_run_s`). `cameras` is the estimated cameras
over the ground truth's views; `vs_baseline` is the reference's published
fountain-11 median (2.0 mm) over this run's.
"""

from __future__ import annotations

import argparse
import json

from ..pipelines import fountain


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--estimator", default="global",
                    choices=["global", "incremental", "hybrid"])
    ap.add_argument("--max-tracks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--tracks", default=fountain.DEFAULT_FOUNTAIN,
                    help="feature tracks with their intrinsics priors (a Theia .recon file)")
    ap.add_argument("--gt", default=fountain.DEFAULT_GT,
                    help="the ground-truth reconstruction (a Theia .recon file)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, which must be present)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    runs = [
        fountain.evaluate(
            estimator_type=args.estimator,
            max_tracks=args.max_tracks,
            seed=args.seed,
            fountain_path=args.tracks,
            gt_path=args.gt,
            device=args.device,
        )
        for _ in range(max(args.repeat, 1))
    ]
    first, last = runs[0], runs[-1]
    result = {
        "metric": f"fountain11_ate_{args.estimator}",
        "value": round(last["median_mm"], 3),
        "unit": "mm median camera-center error (Sim3-aligned, Strecha GT)",
        "vs_baseline": round(2.0 / max(last["median_mm"], 1e-9), 3),
        "mean_mm": round(last["mean_mm"], 3),
        "max_mm": round(last["max_mm"], 3),
        "cameras": f"{last['cameras']}/{last['gt_cameras']}",
        "edges": last["edges"],
        "tracks_used": last["tracks_used"],
        "t_verify_s": round(last["t_verify_s"], 2),
        "t_sfm_s": round(last["t_sfm_s"], 2),
        "t_sfm_pose_s": round(last["t_sfm_pose_s"], 2),
        "t_sfm_triangulation_s": round(last["t_sfm_triangulation_s"], 2),
        "t_sfm_ba_s": round(last["t_sfm_ba_s"], 2),
        "t_total_s": round(last["t_total_s"], 2),
        "t_total_first_run_s": round(first["t_total_s"], 2),
        "success": bool(last["success"]),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
