"""SIFT in PyTorch: scale-space keypoints and 128-D descriptors on a device.

Counterpart of the JAX package's `features/sift.py` (itself the package's
replacement for the OpenCV SIFT of the reference's Python pipelines,
`pytests/sfm_pipeline.py:175-230`). The same stages, as eager tensor
programs on the chosen device:

  pyramid     separable Gaussian convolutions (`conv2d`, zero padding, true
              f32) over a fixed octave and scale grid
  detection   26-neighbour DoG extrema (3x3x3 max and min pools), contrast
              and edge (Hessian-ratio) gates, border mask, the top K per
              octave (a stable sort: equal scores lowest index first, as
              `lax.top_k`)
  descriptor  per-keypoint 16x16 gradient patches gathered by index
              arithmetic (the window clamped into the image as
              `lax.dynamic_slice` clamps it), 4x4 spatial x 8 orientation
              bins with bilinear soft assignment, SIFT
              normalize-clip-renormalize

`SiftParams.upright=True` (default) skips orientation assignment;
`upright=False` adds the 36-bin dominant orientation and rotated bilinear
sampling. Only the keypoints that pass every gate are described.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device

__all__ = ["SiftParams", "detect_and_describe", "load_grayscale"]


@dataclasses.dataclass(frozen=True)
class SiftParams:
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.015
    edge_ratio: float = 10.0
    max_features_per_octave: int = 1024
    descriptor_patch: int = 16  # 16x16 gradient window -> 4x4x8 = 128-D
    # True (default): axis-aligned descriptors. False: dominant-orientation
    # assignment (36-bin gradient histogram) + rotated descriptor sampling.
    upright: bool = True


# The header of an 8-bit binary PGM: "P5", width, height, maxval, with
# whitespace and '#' comments between the fields and one whitespace byte
# before the raster.
_SEP = rb"(?:\s|#[^\r\n]*[\r\n])+"
_PGM_HEADER = re.compile(rb"P5" + _SEP + rb"(\d+)" + _SEP + rb"(\d+)" + _SEP + rb"(\d+)\s")


def _read_pgm(path: str) -> np.ndarray | None:
    """An 8-bit binary PGM (`P5`, maxval 255) as a uint8 [H, W] array; None
    for any other file."""
    with open(path, "rb") as f:
        data = f.read()
    header = _PGM_HEADER.match(data)
    if header is None or int(header.group(3)) != 255:
        return None
    width, height = int(header.group(1)), int(header.group(2))
    return np.frombuffer(data, np.uint8, width * height, header.end()).reshape(height, width)


def load_grayscale(path: str, max_dim: int | None = 1024) -> np.ndarray:
    """Load an image as float32 grayscale in [0, 1], resized (PIL BILINEAR)
    so that max(H, W) == max_dim when it is larger.

    An 8-bit binary PGM that needs no resize is decoded here with numpy, to
    the array PIL's ``convert("L")`` gives; every other file, and a resize,
    goes through PIL, which is then required."""
    raster = _read_pgm(path)
    if raster is not None and (max_dim is None or max(raster.shape) <= max_dim):
        return raster.astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"reading {path} needs PIL (Pillow): only an 8-bit binary PGM at most "
            f"max_dim={max_dim} pixels on a side is decoded without it"
        ) from exc
    img = Image.open(path).convert("L")
    if max_dim is not None and max(img.size) > max_dim:
        w, h = img.size
        s = max_dim / max(w, h)
        img = img.resize((int(round(w * s)), int(round(h * s))), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(np.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur with SAME zero padding ([H, W])."""
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    r = (len(kernel) - 1) // 2
    x = F.conv2d(img[None, None], k.view(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
    return x[0, 0]


def _octave_keypoints(dogs: torch.Tensor, params: SiftParams):
    """DoG extrema in one octave. dogs [L, H, W] -> (score [K], y [K], x [K],
    lvl [K]) of the keypoints that pass every gate, at most
    `max_features_per_octave`, by score descending, equal scores in
    ascending flat index (the order of `lax.top_k`)."""
    L, H, W = dogs.shape
    thr = params.contrast_threshold
    r_edge = (params.edge_ratio + 1.0) ** 2 / params.edge_ratio
    center = dogs[1 : L - 1]

    # The 26-neighbour test: center >= all 27 values of its 3x3x3 block is
    # center == their max (min likewise); "strict on one neighbour" is
    # max != min. Pooling pads where the JAX form rolls around, which only
    # changes pixels that the border mask below drops.
    block = dogs[None, None]
    mx = F.max_pool3d(block, 3, stride=1, padding=(0, 1, 1))[0, 0]
    mn = -F.max_pool3d(-block, 3, stride=1, padding=(0, 1, 1))[0, 0]
    extremum = ((center >= mx) | (center <= mn)) & (mx != mn) & (center.abs() > thr)

    # Edge gate: 2x2 spatial Hessian trace^2/det ratio (Lowe Sec. 4.1).
    dxx = torch.roll(center, -1, -1) + torch.roll(center, 1, -1) - 2 * center
    dyy = torch.roll(center, -1, -2) + torch.roll(center, 1, -2) - 2 * center
    dxy = 0.25 * (
        torch.roll(center, (-1, -1), (-2, -1))
        + torch.roll(center, (1, 1), (-2, -1))
        - torch.roll(center, (-1, 1), (-2, -1))
        - torch.roll(center, (1, -1), (-2, -1))
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / torch.where(det <= 0, 1.0, det) < r_edge)

    # Border mask (descriptor window + neighbour shifts stay inside; rotated
    # sampling reads a sqrt(2)-larger window).
    b = params.descriptor_patch // 2 + (2 if params.upright else 6)
    good = extremum & edge_ok
    good[:, :b] = False
    good[:, H - b :] = False
    good[:, :, :b] = False
    good[:, :, W - b :] = False

    idx = torch.nonzero(good.reshape(-1)).squeeze(1)  # ascending flat index
    score = center.abs().reshape(-1)[idx]
    order = torch.sort(score, descending=True, stable=True).indices
    order = order[: params.max_features_per_octave]
    idx, score = idx[order], score[order]
    lvl = idx // (H * W)
    rem = idx % (H * W)
    return score, rem // W, rem % W, lvl


def _window(img: torch.Tensor, lv, y0, x0, size: int) -> torch.Tensor:
    """[K, size, size] windows of img [L, H, W] at level lv [K] and top-left
    (y0, x0) [K], the start clamped so the window lies inside the image
    (`lax.dynamic_slice`)."""
    _, H, W = img.shape
    ar = torch.arange(size, device=img.device)
    ys = y0.clamp(0, H - size)[:, None] + ar
    xs = x0.clamp(0, W - size)[:, None] + ar
    return img[lv[:, None, None], ys[:, :, None], xs[:, None, :]]


def _spatial_weights(P: int) -> np.ndarray:
    """The bilinear soft assignment of the PxP grid into 4x4 cells times the
    Gaussian window, [P*P, 16] (f32 values, as the JAX module rounds them)."""
    g = np.arange(P, dtype=np.float64) - (P - 1) / 2.0
    cell = (g + (P - 1) / 2.0) / (P / 4.0) - 0.5
    w_sp = np.zeros((P, 4))
    for c in range(4):
        w_sp[:, c] = np.clip(1.0 - np.abs(cell - c), 0.0, 1.0)
    gw = np.exp(-0.5 * (g / (0.5 * P)) ** 2)
    Wspat = (
        (gw[:, None, None, None] * gw[None, :, None, None])
        * w_sp[:, None, :, None]
        * w_sp[None, :, None, :]
    ).reshape(P * P, 16)
    return Wspat.astype(np.float32)


def _finish(m: torch.Tensor, a: torch.Tensor, Wspat: torch.Tensor) -> torch.Tensor:
    """m, a [K, P*P] gradient magnitudes and angles -> [K, 128]."""
    binf = (a + math.pi) / (2 * math.pi) * 8.0 - 0.5
    b0 = torch.floor(binf)
    frac = binf - b0
    b0i = torch.remainder(b0.to(torch.int64), 8)
    b1i = torch.remainder(b0i + 1, 8)
    bins = torch.arange(8, device=m.device)
    w_ang = (b0i[..., None] == bins) * (1.0 - frac)[..., None] + (
        b1i[..., None] == bins
    ) * frac[..., None]  # [K, P*P, 8]
    hist = torch.einsum("pc,kpo,kp->kco", Wspat, w_ang, m)
    d = hist.reshape(len(m), 128)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    d = torch.clamp_max(d, 0.2)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)


def _descriptors(gauss, y, x, lvl, params: SiftParams) -> torch.Tensor:
    """[K, 128] L2-normalized descriptors of one octave's keypoints (y, x, lvl
    [K]); gradients from the Gaussian level above each DoG level."""
    P = params.descriptor_patch
    dev, dt = gauss.device, gauss.dtype
    dx = 0.5 * (torch.roll(gauss, -1, -1) - torch.roll(gauss, 1, -1))
    dy = 0.5 * (torch.roll(gauss, -1, -2) - torch.roll(gauss, 1, -2))
    Wspat = torch.as_tensor(_spatial_weights(P), dtype=dt, device=dev)
    lv = (lvl + 1).clamp(0, gauss.shape[0] - 1)
    K = len(y)
    if K == 0:
        return torch.zeros((0, 16 * 8), dtype=dt, device=dev)

    if params.upright:
        half = P // 2
        dxw = _window(dx, lv, y - half, x - half, P).reshape(K, -1)
        dyw = _window(dy, lv, y - half, x - half, P).reshape(K, -1)
        return _finish(torch.sqrt(dxw * dxw + dyw * dyw), torch.atan2(dyw, dxw), Wspat)

    S = P + 8
    halfS = S // 2
    dxw = _window(dx, lv, y - halfS, x - halfS, S)
    dyw = _window(dy, lv, y - halfS, x - halfS, S)

    # Dominant orientation: 36-bin Gaussian-weighted histogram of the window
    # gradients, circularly smoothed (Lowe Sec. 5). A one-hot sum keeps the
    # order of the additions fixed on every device.
    gS = np.arange(S, dtype=np.float64) - (S - 1) / 2.0
    ori_w = np.exp(-0.5 * (gS / (0.5 * P)) ** 2)
    OriW = torch.as_tensor((ori_w[:, None] * ori_w[None, :]).astype(np.float32), dtype=dt,
                           device=dev)
    mw = (torch.sqrt(dxw * dxw + dyw * dyw) * OriW).reshape(K, -1)
    aw = torch.atan2(dyw, dxw).reshape(K, -1)
    bins = torch.remainder(
        torch.floor((aw + math.pi) / (2 * math.pi) * 36.0).to(torch.int64), 36)
    hist = ((bins[..., None] == torch.arange(36, device=dev)) * mw[..., None]).sum(1)
    for _ in range(2):
        hist = (
            hist * 6.0
            + (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1)) * 4.0
            + (torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1))
        ) / 16.0
    theta = (torch.argmax(hist, -1).to(dt) + 0.5) / 36.0 * (2 * math.pi) - math.pi
    cs, sn = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]

    # Sample the gradient field on the theta-rotated grid (bilinear) and
    # rotate the gradient vectors into the keypoint frame, with the same
    # R(theta) for both.
    g_off = torch.as_tensor(np.arange(P, dtype=np.float32) - (P - 1) / 2.0, dtype=dt,
                            device=dev)
    uu, vv = torch.meshgrid(g_off, g_off, indexing="ij")
    ys = sn * vv + cs * uu + (S - 1) / 2.0
    xs = cs * vv - sn * uu + (S - 1) / 2.0
    yf = torch.floor(ys).to(torch.int64).clamp(0, S - 2)
    xf = torch.floor(xs).to(torch.int64).clamp(0, S - 2)
    fy = (ys - yf).clamp(0.0, 1.0).reshape(K, -1)
    fx = (xs - xf).clamp(0.0, 1.0).reshape(K, -1)
    flat = (yf * S + xf).reshape(K, -1)

    def samp(img2):
        img2 = img2.reshape(K, -1)
        v00 = torch.gather(img2, 1, flat)
        v01 = torch.gather(img2, 1, flat + 1)
        v10 = torch.gather(img2, 1, flat + S)
        v11 = torch.gather(img2, 1, flat + S + 1)
        return (
            v00 * (1 - fy) * (1 - fx)
            + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx)
            + v11 * fy * fx
        )

    dxs, dys = samp(dxw), samp(dyw)
    cs, sn = cs.reshape(K, 1), sn.reshape(K, 1)
    dxr = cs * dxs + sn * dys
    dyr = -sn * dxs + cs * dys
    return _finish(torch.sqrt(dxr * dxr + dyr * dyr), torch.atan2(dyr, dxr), Wspat)


def _extract_octave(img: torch.Tensor, params: SiftParams):
    """One octave: pyramid levels, extrema, descriptors."""
    s = params.scales_per_octave
    k = 2.0 ** (1.0 / s)
    levels = [img]
    sig_prev = params.sigma0
    for i in range(1, s + 3):
        sig_total = params.sigma0 * (k**i)
        sig_inc = float(np.sqrt(max(sig_total**2 - sig_prev**2, 1e-6)))
        levels.append(_blur(levels[-1], _gaussian_kernel1d(sig_inc)))
        sig_prev = sig_total
    gauss = torch.stack(levels)  # [s+3, H, W]
    dogs = gauss[1:] - gauss[:-1]  # [s+2, H, W]
    score, y, x, lvl = _octave_keypoints(dogs, params)
    desc = _descriptors(gauss, y, x, lvl, params)
    next_img = levels[s][::2, ::2]  # 2x-downsampled seed for next octave
    return score, y, x, lvl, desc, next_img


def detect_and_describe(
    image: np.ndarray,
    params: SiftParams | None = None,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Full pyramid over `num_octaves` on `device` (None: the CUDA card).
    Returns (keypoints [N, 2] (x, y) original-image pixels, scales [N],
    descriptors [N, 128], responses [N]) as numpy, valid rows only, sorted
    by response (stable). `dtype` is the pyramid's (float64 for parity
    checks)."""
    params = params or SiftParams()
    device = default_device(device)
    base_sigma = float(np.sqrt(max(params.sigma0**2 - 0.5**2, 1e-6)))
    img = torch.as_tensor(np.asarray(image, np.float32), device=device).to(dtype)
    img = _blur(img, _gaussian_kernel1d(base_sigma))

    k = 2.0 ** (1.0 / params.scales_per_octave)
    kps, scales, descs, resps = [], [], [], []
    for o in range(params.num_octaves):
        if min(img.shape) < 4 * params.descriptor_patch:
            break
        score, y, x, lvl, desc, img = _extract_octave(img, params)
        xy = torch.stack([x, y], -1).cpu().numpy().astype(np.float64)
        kps.append((xy + 0.5) * (2.0**o) - 0.5)
        scales.append(params.sigma0 * (k ** (lvl.cpu().numpy() + 1)) * (2.0**o))
        descs.append(desc.cpu().numpy())
        resps.append(score.cpu().numpy())
    if not kps:
        return (
            np.zeros((0, 2)),
            np.zeros((0,)),
            np.zeros((0, 128), np.float32),
            np.zeros((0,)),
        )
    kp = np.concatenate(kps)
    sc = np.concatenate(scales)
    de = np.concatenate(descs)
    rs = np.concatenate(resps)
    order = np.argsort(-rs, kind="stable")
    return kp[order], sc[order], de[order], rs[order]
