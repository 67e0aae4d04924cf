"""Reconstruction -> MVS view selection -> MVSNet inputs, the user's command.

The port's form of the repository's `tools/mvs_pipeline.py` (the
reference's `pyexamples/mvs_pipeline_fountain.py`): reads a reconstruction
(the npz checkpoint of `io.recon`, or else a Theia `.recon` archive), runs
`mvs.view_selection_mvsnet` (covisibility- and angle-scored neighbours) on
the CUDA card unless `--device cpu` is given, and with `--out` writes the
MVSNet `pair.txt` and one `cam_XXXXXXXX.txt` a view, in the JAX command's
format.

    python -m pytheiasfm_tpu_torch.tools.mvs_pipeline RECON [--neighbors 10]
        [--out DIR] [--device cuda|cpu]

Prints one JSON line with the JAX command's keys.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io.recon import read_reconstruction
from ..io.theia_recon import read_theia_reconstruction
from ..models.intrinsics import _PP_INDEX
from ..mvs.view_selection import view_selection_mvsnet
from ..ops.rotation_np import angle_axis_to_rotation_matrix_np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recon")
    ap.add_argument("--neighbors", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, which must be present)")
    return ap.parse_args(argv)


def write_pair_file(path, selection):
    """MVSNet `pair.txt`: the view count, then each view with its scored
    neighbours."""
    with open(path, "w") as f:
        f.write(f"{len(selection)}\n")
        for v in selection:
            f.write(f"{v}\n{len(selection[v])}")
            for score, nb in selection[v]:
                f.write(f" {nb} {score:.4f}")
            f.write("\n")


def write_camera_file(path, recon, v):
    """One view's world->camera [R | t] and K (focal at slot 0, aspect at
    1, the principal point at the model's `_PP_INDEX`)."""
    R = angle_axis_to_rotation_matrix_np(recon.view_extrinsics[v, 3:])
    t = -R @ recon.view_extrinsics[v, :3]
    g = recon.view_group[v]
    p = recon.intrinsics[g]
    pp = _PP_INDEX[recon.group_model[g]]
    fx, fy = p[0], p[0] * p[1]
    cx, cy = p[pp], p[pp + 1]
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(3):
            f.write(f"{R[i,0]} {R[i,1]} {R[i,2]} {t[i]}\n")
        f.write("0 0 0 1\nintrinsic\n")
        f.write(f"{fx} 0 {cx}\n0 {fy} {cy}\n0 0 1\n")


def main(argv=None) -> dict:
    args = parse_args(argv)
    read = read_reconstruction if args.recon.endswith(".npz") else read_theia_reconstruction
    recon = read(args.recon)
    selection = view_selection_mvsnet(recon, args.neighbors, device=args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        write_pair_file(os.path.join(args.out, "pair.txt"), selection)
        for v in selection:
            write_camera_file(os.path.join(args.out, f"cam_{v:08d}.txt"), recon, v)
    result = {
        "metric": "mvs_view_selection",
        "value": sum(1 for v in selection if selection[v]),
        "unit": "views with MVS neighbors",
        "views": len(selection),
        "avg_neighbors": round(
            float(np.mean([len(s) for s in selection.values()] or [0])), 2),
        "out": args.out,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
