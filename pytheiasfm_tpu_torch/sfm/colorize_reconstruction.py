"""Colorize reconstruction tracks from source images.

Counterpart of the JAX package's `sfm/colorize_reconstruction.py`
(`theia/sfm/colorize_reconstruction.{h,cc}`): the reference loads the images
over a thread pool and averages, for each track, the image color at each
observing feature. Here each image's feature colors are one bilinear gather
and the per-track sums one `index_add_`, on `device` (None: the CUDA card)
in f64; images load on the host (PIL by default, imported when called).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import default_device

__all__ = ["colorize_reconstruction", "sample_bilinear"]


def sample_bilinear(image, uv):
    """Bilinear color sampling. image [H, W, C] or [H, W] (array or
    tensor), uv [N, 2] pixel coordinates (x, y). Returns [N, C] float64, a
    tensor on the image's device for a tensor image, numpy otherwise."""
    as_numpy = not isinstance(image, torch.Tensor)
    img = torch.as_tensor(np.asarray(image) if as_numpy else image).to(torch.float64)
    if img.ndim == 2:
        img = img[..., None]
    uv = torch.as_tensor(uv, dtype=torch.float64, device=img.device)
    h, w = img.shape[:2]
    x = torch.clamp(uv[:, 0], 0.0, w - 1.0)
    y = torch.clamp(uv[:, 1], 0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
           + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)
    return out.numpy() if as_numpy else out


def _pil_rgb(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def colorize_reconstruction(recon, image_directory: str, image_loader=None, device=None) -> int:
    """Set `recon.track_colors` from the images named by `recon.view_names`.

    Parity: `theia::ColorizeReconstruction(image_directory, num_threads,
    recon)` (`colorize_reconstruction.h`). `image_loader(path) -> [H, W, 3]
    or [H, W] uint8` may be given (default: Pillow, RGB). A view whose image
    is missing is skipped. Returns the number of tracks colorized.
    """
    device = default_device(device)
    image_loader = image_loader or _pil_rgb
    T = recon.num_tracks()
    color_sum = torch.zeros((T, 3), dtype=torch.float64, device=device)
    color_cnt = torch.zeros((T,), dtype=torch.int64, device=device)
    obs_view = np.asarray(recon.obs_view)
    obs_track = np.asarray(recon.obs_track)
    obs_uv = np.asarray(recon.obs_uv, np.float64)

    for v, name in enumerate(recon.view_names):
        base = name if os.path.isabs(name) else os.path.join(image_directory, name)
        path = next((c for c in (base, base + ".png", base + ".jpg", base + ".jpeg")
                     if os.path.exists(c)), None)
        if path is None:
            continue
        rows = np.flatnonzero(obs_view == v)
        if len(rows) == 0:
            continue
        image = torch.as_tensor(np.array(image_loader(path)), device=device)
        colors = sample_bilinear(image, torch.as_tensor(obs_uv[rows], device=device))
        if colors.shape[1] == 1:
            colors = colors.expand(-1, 3)
        tracks = torch.as_tensor(obs_track[rows], dtype=torch.int64, device=device)
        color_sum.index_add_(0, tracks, colors[:, :3])
        color_cnt.index_add_(0, tracks, torch.ones_like(tracks))

    seen = (color_cnt > 0).cpu().numpy()
    mean = (color_sum / torch.clamp(color_cnt, min=1)[:, None]).cpu().numpy()
    recon.track_colors[seen] = np.clip(mean[seen], 0, 255).astype(np.uint8)
    return int(seen.sum())
