"""The images pipeline's full-width scene: rendered views of textured boxes.

32 pinhole views, 1024x768 8-bit grayscale, f = 1.2 x 1024 px (the images
pipeline's own default prior) and the principal point at the image centre.
The cameras sit on a ring of radius 14 m at a height of 4 +- 0.5 m, evenly
spaced at 11.25 deg with up to +-1 deg of jitter, each looking at a point
near the scene centre. The world: a square ground plane and 8 axis-aligned
boxes, 1-3 m on a side, placed without overlap within 5 m of the centre;
every face carries its own texture (band-limited noise plus Gaussian
blobs, as `tests/test_sift_quality._textured` makes them). Rays that hit
nothing are a constant grey.

Rendering: one ray per pixel centre (pixel (i, j) at image coordinates
(i, j), as the SIFT keypoints count them), the nearest hit, a bilinear
lookup into the hit face's texture, then +-1 grey level of uniform noise
before quantisation. Everything is made with numpy in float64 from a seed;
a view's image does not depend on which other views are rendered.

    python -m pytheiasfm_tpu_torch.tools.image_scene OUT_DIR [--width W --height H]

writes `view_00.pgm`, ... (8-bit binary PGM) and prints the SHA-256 of the
stacked images.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
from pathlib import Path

import numpy as np

from ..ops.rotation_np import rotation_matrix_to_angle_axis_np

__all__ = ["Scene", "images_sha256", "make_scene", "render", "view_name", "write_pgm",
           "write_views"]

NUM_VIEWS = 32
WIDTH, HEIGHT = 1024, 768
RING_RADIUS = 14.0
CAMERA_HEIGHT = 4.0
NUM_BOXES = 8
# The tuning of the texture and the layout, fixed before the port first ran
# the scene at full width (PERF.md, section 4): texels per metre on the
# faces, blobs per square texel, the ground plane's half-side (m) and the
# constant grey of the empty background.
TEXELS_PER_M = 80.0
BLOBS_PER_TEXEL2 = 0.01
GROUND_HALF_SIDE = 12.0
BACKGROUND = 0.5


def view_name(v: int) -> str:
    return f"view_{v:02d}.pgm"


@dataclasses.dataclass
class Scene:
    """The world and the cameras. Boxes are [min xyz, max xyz]; a face is
    (box or -1 for the ground, axis, side) with its texture; cameras are
    ground-truth extrinsics [V, 6] (position, world-to-camera angle-axis)
    and rotations [V, 3, 3]."""

    boxes: np.ndarray
    faces: list
    textures: list
    positions: np.ndarray
    rotations: np.ndarray

    @property
    def extrinsics(self) -> np.ndarray:
        aa = np.stack([rotation_matrix_to_angle_axis_np(R) for R in self.rotations])
        return np.concatenate([self.positions, aa], axis=1)


def _box5(img):
    """5-tap box blur along both axes, zero padding (np.convolve 'same')."""
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (2, 2)
        p = np.pad(img, pad)
        n = img.shape[axis]
        img = sum(np.take(p, np.arange(k, k + n), axis=axis) for k in range(5)) / 5.0
    return img


def _texture(rng, nv: int, nu: int) -> np.ndarray:
    """Band-limited noise plus Gaussian blobs, its 1st..99th percentile
    stretched onto [0, 1] and clipped."""
    img = 0.5 * _box5(rng.normal(size=(nv, nu)))
    n = max(1, int(round(BLOBS_PER_TEXEL2 * nv * nu)))
    cy = rng.uniform(0, nv, n)
    cx = rng.uniform(0, nu, n)
    s = rng.uniform(1.5, 5.0, n)
    a = rng.choice([-1.0, 1.0], n) * rng.uniform(2.0, 4.0, n)
    for y, x, sg, amp in zip(cy, cx, s, a):
        r = int(np.ceil(4 * sg))
        y0, y1 = max(int(y) - r, 0), min(int(y) + r + 1, nv)
        x0, x1 = max(int(x) - r, 0), min(int(x) + r + 1, nu)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * sg * sg))
    lo, hi = np.percentile(img, [1.0, 99.0])
    return np.clip((img - lo) / (hi - lo), 0.0, 1.0)


def _boxes(rng) -> np.ndarray:
    """NUM_BOXES axis-aligned boxes on the ground, 1-3 m a side, footprints
    within 5 m of the centre and 0.3 m apart."""
    boxes = []
    while len(boxes) < NUM_BOXES:
        size = rng.uniform(1.0, 3.0, 3)
        r = rng.uniform(0, 5.0)
        phi = rng.uniform(0, 2 * np.pi)
        c = np.array([r * np.cos(phi), r * np.sin(phi)])
        lo, hi = c - size[:2] / 2, c + size[:2] / 2
        corners = np.array([[x, y] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])])
        if np.linalg.norm(corners, axis=1).max() > 5.0:
            continue
        if any(np.all(lo < b[3:5] + 0.3) and np.all(b[0:2] - 0.3 < hi) for b in boxes):
            continue
        boxes.append(np.array([lo[0], lo[1], 0.0, hi[0], hi[1], size[2]]))
    return np.stack(boxes)


def _look_at(center, target):
    z = target - center
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])  # world->camera, image y down


def make_scene(seed: int = 0) -> Scene:
    """The world and the NUM_VIEWS cameras of `seed`."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng)
    faces, textures = [], []
    side = int(np.ceil(2 * GROUND_HALF_SIDE * TEXELS_PER_M)) + 2
    faces.append((-1, 2, 1))
    textures.append(_texture(rng, side, side))
    for b, box in enumerate(boxes):
        ext = box[3:] - box[:3]
        for axis in range(3):
            u, v = [a for a in range(3) if a != axis]
            for s in (0, 1):
                if axis == 2 and s == 0:
                    continue  # the bottom face lies on the ground
                nv = int(np.ceil(ext[v] * TEXELS_PER_M)) + 2
                nu = int(np.ceil(ext[u] * TEXELS_PER_M)) + 2
                faces.append((b, axis, s))
                textures.append(_texture(rng, nv, nu))
    angles = np.deg2rad(360.0 / NUM_VIEWS * np.arange(NUM_VIEWS)
                        + rng.uniform(-1.0, 1.0, NUM_VIEWS))
    heights = CAMERA_HEIGHT + rng.uniform(-0.5, 0.5, NUM_VIEWS)
    positions = np.stack([RING_RADIUS * np.cos(angles), RING_RADIUS * np.sin(angles),
                          heights], -1)
    targets = np.concatenate([rng.uniform(-0.5, 0.5, (NUM_VIEWS, 2)),
                              rng.uniform(0.5, 1.0, (NUM_VIEWS, 1))], axis=1)
    rotations = np.stack([_look_at(c, t) for c, t in zip(positions, targets)])
    return Scene(boxes, faces, textures, positions, rotations)


def _bilinear(tex, u, v):
    nv, nu = tex.shape
    u0 = np.clip(np.floor(u).astype(np.int64), 0, nu - 2)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, nv - 2)
    fu = np.clip(u - u0, 0.0, 1.0)
    fv = np.clip(v - v0, 0.0, 1.0)
    return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0, u0 + 1] * (1 - fv) * fu
            + tex[v0 + 1, u0] * fv * (1 - fu) + tex[v0 + 1, u0 + 1] * fv * fu)


def _render_view(scene: Scene, v: int, width: int, height: int, seed: int) -> np.ndarray:
    focal = 1.2 * width
    jj, ii = np.mgrid[0:height, 0:width].astype(np.float64)
    d = np.stack([(ii - width / 2) / focal, (jj - height / 2) / focal,
                  np.ones_like(ii)], -1).reshape(-1, 3) @ scene.rotations[v]
    c = scene.positions[v]
    t_best = np.full(len(d), np.inf)
    hit = np.full(len(d), -1)  # index into scene.faces
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d[:, 2] < 0, -c[2] / d[:, 2], np.inf)
        p = c + t[:, None] * d
        on = np.all(np.abs(p[:, :2]) <= GROUND_HALF_SIDE, axis=1) & (t < t_best)
        t_best[on], hit[on] = t[on], 0
        face_index = {f: i for i, f in enumerate(scene.faces)}
        for b, box in enumerate(scene.boxes):
            t1 = (box[:3] - c) / d
            t2 = (box[3:] - c) / d
            near = np.minimum(t1, t2)
            t_in = near.max(axis=1)
            t_out = np.maximum(t1, t2).min(axis=1)
            on = (t_in <= t_out) & (t_in > 0) & (t_in < t_best)
            axis = near.argmax(axis=1)
            side = (d[np.arange(len(d)), axis] < 0).astype(np.int64)
            t_best[on] = t_in[on]
            for a in range(3):
                for s in (0, 1):
                    sel = on & (axis == a) & (side == s)
                    if (b, a, s) in face_index:
                        hit[sel] = face_index[(b, a, s)]
    value = np.full(len(d), BACKGROUND)
    p = c + np.where(np.isfinite(t_best), t_best, 0.0)[:, None] * d
    for f, (b, axis, _) in enumerate(scene.faces):
        sel = hit == f
        if not sel.any():
            continue
        u, w = [a for a in range(3) if a != axis]
        origin = -GROUND_HALF_SIDE * np.ones(3) if b < 0 else scene.boxes[b, :3]
        # Texel (i, j) sits at origin + (i, j) / TEXELS_PER_M, one texel of margin.
        uu = (p[sel, u] - origin[u]) * TEXELS_PER_M + 0.5
        vv = (p[sel, w] - origin[w]) * TEXELS_PER_M + 0.5
        value[sel] = _bilinear(scene.textures[f], uu, vv)
    noise = np.random.default_rng([seed, v]).uniform(-1.0, 1.0, len(d))
    grey = np.clip(np.round(value * 255.0 + noise), 0, 255)
    return grey.astype(np.uint8).reshape(height, width)


def render(seed: int = 0, views=None, width: int = WIDTH, height: int = HEIGHT):
    """Render `views` (default: all NUM_VIEWS) of the scene of `seed` at
    width x height (focal 1.2 x width, principal point at the centre).
    Returns (images [V, H, W] uint8, ground-truth extrinsics [V, 6])."""
    scene = make_scene(seed)
    views = list(range(NUM_VIEWS)) if views is None else list(views)
    images = np.stack([_render_view(scene, v, width, height, seed) for v in views])
    return images, scene.extrinsics[views]


def images_sha256(images: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(images, np.uint8).tobytes()).hexdigest()


def write_pgm(path, image: np.ndarray) -> None:
    """An 8-bit binary PGM (P5, maxval 255)."""
    h, w = image.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image, np.uint8).tobytes())


def write_views(out_dir, images: np.ndarray, views=None) -> list[str]:
    """Write each image as `view_XX.pgm` into out_dir; returns the paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    views = range(len(images)) if views is None else views
    paths = []
    for v, img in zip(views, images):
        path = out / view_name(v)
        write_pgm(path, img)
        paths.append(str(path))
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    args = parser.parse_args(argv)
    images, _ = render(args.seed, width=args.width, height=args.height)
    write_views(args.out_dir, images)
    print(images_sha256(images))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
