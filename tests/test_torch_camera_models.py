"""The port's host rotations, PINHOLE camera model, camera projection and
Umeyama alignment against the JAX package's, in f64 on the same numpy inputs.

Tolerances: rotations 1e-12 (the JAX test's own bar, `tests/test_rotation_np.py`);
pixels 1e-9 absolute on values of order 1e3, normalized rays 1e-12 (the same
closed-form f64 arithmetic); Umeyama R, t and s within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytheiasfm_tpu.models import camera as jcam
from pytheiasfm_tpu.models import intrinsics as jintr
from pytheiasfm_tpu.ops import rotation_np as jrnp
from pytheiasfm_tpu.transforms import alignment as jalign
from pytheiasfm_tpu_torch.models import camera as tcam
from pytheiasfm_tpu_torch.models import intrinsics as tintr
from pytheiasfm_tpu_torch.ops import rotation_np as trnp
from pytheiasfm_tpu_torch.transforms import alignment as talign

M = tintr.CameraIntrinsicsModelType


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _rotations(rng):
    """The inputs of `tests/test_rotation_np.py`, with its edge cases: zero,
    a tiny angle, and angles at and next to pi."""
    aa = rng.normal(size=(64, 3)) * rng.uniform(0, np.pi, (64, 1))
    aa[0] = 0.0
    aa[1] = [1e-14, 0, 0]
    for k, axis in enumerate(([1.0, 0, 0], [0, 1.0, 0], [0.6, -0.8, 0])):
        aa[2 + 2 * k] = np.asarray(axis) * np.pi
        aa[3 + 2 * k] = np.asarray(axis) * (np.pi - 1e-9)
    return aa


def test_rotation_np_matches_jax(rng):
    aa = _rotations(rng)
    R = trnp.angle_axis_to_rotation_matrix_np(aa)
    np.testing.assert_allclose(R, jrnp.angle_axis_to_rotation_matrix_np(aa), atol=1e-12)
    np.testing.assert_allclose(
        trnp.rotation_matrix_to_angle_axis_np(R), jrnp.rotation_matrix_to_angle_axis_np(R),
        atol=1e-12,
    )
    assert trnp.rotation_matrix_to_angle_axis_np(R[5]).shape == (3,)
    pts = rng.normal(size=(64, 3))
    np.testing.assert_allclose(
        trnp.angle_axis_rotate_point_np(aa, pts), jrnp.angle_axis_rotate_point_np(aa, pts),
        atol=1e-12,
    )


def test_pinhole_projection_and_unprojection_match_jax(rng):
    params = jintr.make_intrinsics_np(
        M.PINHOLE, focal_length=1000.0, aspect_ratio=1.1, skew=0.5,
        principal_point=(640.0, 480.0), distortion=(-0.1, 0.02),
    )
    np.testing.assert_array_equal(
        tintr.make_intrinsics_np(
            M.PINHOLE, focal_length=1000.0, aspect_ratio=1.1, skew=0.5,
            principal_point=(640.0, 480.0), distortion=(-0.1, 0.02),
        ),
        params,
    )
    ext = np.concatenate([rng.normal(size=(50, 3)), rng.normal(size=(50, 3)) * 0.3], 1)
    pts = rng.uniform(-2, 2, (50, 3)) + np.array([0.0, 0.0, 8.0])
    depth, pix = tcam.project_point(_t(ext), _t(params), _t(pts), M.PINHOLE)
    jdepth, jpix = jcam.project_point(
        jnp.asarray(ext), jnp.asarray(params), jnp.asarray(pts), M.PINHOLE
    )
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=1e-12)
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), atol=1e-9)
    pixels = rng.uniform(0, 1280, (50, 2))
    ray = tcam.pixel_to_normalized_batch(_t(params), _t(pixels), M.PINHOLE)
    jray = jcam.pixel_to_normalized_batch(jnp.asarray(params), jnp.asarray(pixels), M.PINHOLE)
    np.testing.assert_allclose(ray.numpy(), np.asarray(jray), atol=1e-12)
    # Undistortion inverts the distortion at these radii.
    back = tintr.camera_to_pixel(_t(params), ray, M.PINHOLE)
    np.testing.assert_allclose(back.numpy(), pixels, atol=1e-6)


@pytest.mark.parametrize("model", [m for m in M if m != M.PINHOLE])
def test_other_camera_models_are_refused(model):
    with pytest.raises(NotImplementedError, match="A1b"):
        tintr.make_intrinsics_np(model)
    with pytest.raises(NotImplementedError, match="A1b"):
        tintr.pixel_to_camera(torch.zeros(10, dtype=torch.float64),
                              torch.zeros(2, dtype=torch.float64), model)


@pytest.mark.parametrize("weighted", [False, True])
def test_umeyama_matches_jax(rng, weighted):
    left = rng.normal(size=(40, 3))
    R = trnp.angle_axis_to_rotation_matrix_np(rng.normal(size=3))
    right = 2.5 * left @ R.T + rng.normal(size=3) + rng.normal(size=(40, 3)) * 0.01
    w = rng.uniform(0.5, 2.0, 40) if weighted else None
    got = talign.align_point_clouds_umeyama(_t(left), _t(right), None if w is None else _t(w))
    want = jalign.align_point_clouds_umeyama(
        jnp.asarray(left), jnp.asarray(right), None if w is None else jnp.asarray(w)
    )
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-10)
    np.testing.assert_allclose(
        talign.sim3_transform_points(_t(left), *got).numpy(),
        np.asarray(jalign.sim3_transform_points(jnp.asarray(left), *want)),
        atol=1e-10,
    )
