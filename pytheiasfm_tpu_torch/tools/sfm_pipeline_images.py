"""Images -> features -> matches -> reconstruction, the user's command.

The port's form of the repository's `tools/sfm_pipeline_images.py` (the
reference's `pytests/sfm_pipeline.py`): SIFT, matching on the K1 kernel,
two-view verification and SfM through `pipelines.images.run_images_pipeline`,
on the CUDA card unless `--device cpu` is given.

    python -m pytheiasfm_tpu_torch.tools.sfm_pipeline_images IMG [IMG ...]
        [--estimator global|incremental|hybrid] [--max-dim 1024]
        [--max-features 2048] [--ratio 0.85] [--min-inliers 15]
        [--ply out.ply] [--device cuda|cpu] [--verbose]

Prints one JSON line of the pipeline's stats with the keys of the JAX
command (`metric`, `value`, `unit`, and `ply` when one was written).
"""

from __future__ import annotations

import argparse
import json

from ..io.ply import write_ply_file
from ..pipelines.images import run_images_pipeline
from ..utils.log import set_verbosity


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("images", nargs="+")
    ap.add_argument("--estimator", default="global",
                    choices=["global", "incremental", "hybrid"])
    ap.add_argument("--max-dim", type=int, default=1024)
    ap.add_argument("--max-features", type=int, default=2048)
    ap.add_argument("--ratio", type=float, default=0.85)
    ap.add_argument("--min-inliers", type=int, default=15)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, which must be present)")
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.verbose:
        set_verbosity(1)
    models, stats = run_images_pipeline(
        args.images,
        max_dim=args.max_dim,
        max_features=args.max_features,
        estimator_type=args.estimator,
        lowes_ratio=args.ratio,
        min_num_inlier_matches=args.min_inliers,
        device=args.device,
    )
    if args.ply and models:
        write_ply_file(args.ply, models[0])
        stats["ply"] = args.ply
    stats["metric"] = f"images_pipeline_{args.estimator}"
    stats["value"] = stats["views_estimated"]
    stats["unit"] = "views reconstructed from raw images"
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
