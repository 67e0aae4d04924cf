"""The port's host rotations, the eight camera models, camera projection and
Umeyama alignment against the JAX package's, in f64 on the same numpy inputs.

Tolerances: rotations 1e-12 (the JAX test's own bar, `tests/test_rotation_np.py`);
PINHOLE pixels 1e-9 absolute on values of order 1e3, normalized rays 1e-12
(the same closed-form f64 arithmetic); each model at the parameters and
rays of the JAX test `tests/test_camera_models.py` (`MODEL_CASES`): pixels
and rays 1e-10 absolute (DIVISION_UNDISTORTION's pixels 1e-9, see
`PIXEL_TOL`), the round trip at that test's own tolerance, the constructors
and the 64 subset masks equal; Umeyama R, t and s within 1e-10.
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
from test_camera_models import MODEL_CASES, _params, _test_rays

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


def _cases():
    """The JAX camera-model tests' cases (`tests/test_camera_models.py`):
    (model, padded parameters in f64, rays in the model's field of view,
    round-trip tolerance)."""
    return [pytest.param(model, np.asarray(_params(model, dist)), np.asarray(_test_rays(model)),
                         atol, id=model.name) for model, dist, atol in MODEL_CASES]


# DIVISION_UNDISTORTION's projection forms 1 - sqrt(1 - 4 k r^2) with
# 4 k r^2 near -6e-3, which turns one ulp of the square root into 2.6e-10
# px. torch's f64 `sqrt` on an AVX512 CPU is not correctly rounded for 0.8%
# of inputs (numpy's and the card's are), so that model's pixels are held
# at 1e-9; every other value at 1e-10.
PIXEL_TOL = {M.DIVISION_UNDISTORTION: 1e-9}


@pytest.mark.parametrize("model,params,rays,atol", _cases())
def test_camera_model_matches_jax(model, params, rays, atol, rng):
    """`camera_to_pixel`, `pixel_to_camera`, `camera.project_point` and
    `camera.pixel_to_normalized_batch` of each model, port against JAX, f64."""
    tol = PIXEL_TOL.get(model, 1e-10)
    pix = tintr.camera_to_pixel(_t(params), _t(rays), model)
    jpix = np.asarray(jintr.camera_to_pixel(jnp.asarray(params), jnp.asarray(rays), model))
    np.testing.assert_allclose(pix.numpy(), jpix, rtol=0, atol=tol)
    ray = tintr.pixel_to_camera(_t(params), _t(jpix), model)
    jray = jintr.pixel_to_camera(jnp.asarray(params), jnp.asarray(jpix), model)
    np.testing.assert_allclose(ray.numpy(), np.asarray(jray), rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        tcam.pixel_to_normalized_batch(_t(params), _t(jpix), model).numpy(),
        np.asarray(jcam.pixel_to_normalized_batch(jnp.asarray(params), jnp.asarray(jpix),
                                                  model)), rtol=0, atol=1e-10)
    ext = np.concatenate([rng.normal(size=(len(rays), 3)) * 0.1,
                          rng.normal(size=(len(rays), 3)) * 0.05], 1)
    pts = rays * 6.0 + ext[:, :3]
    depth, pix = tcam.project_point(_t(ext), _t(params), _t(pts), model)
    jdepth, jpix = jcam.project_point(jnp.asarray(ext), jnp.asarray(params), jnp.asarray(pts),
                                      model)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=0, atol=1e-10)
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), rtol=0, atol=tol)


@pytest.mark.parametrize("model,params,rays,atol", _cases())
def test_camera_model_round_trip(model, params, rays, atol):
    """Pixel and back in the port at the JAX test's own tolerance, in
    normalized coordinates (ORTHOGRAPHIC: the (x, y) offset itself)."""
    pixels = tintr.camera_to_pixel(_t(params), _t(rays), model)
    assert torch.all(torch.isfinite(pixels))
    back = tintr.pixel_to_camera(_t(params), pixels, model).numpy()
    if model == M.ORTHOGRAPHIC:
        got, want = back[:, :2], rays[:, :2]
    else:
        got, want = back[:, :2] / back[:, 2:3], rays[:, :2] / rays[:, 2:3]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("model", list(M), ids=[m.name for m in M])
def test_intrinsics_constructors_match_jax(model):
    """`default_intrinsics`, `make_intrinsics` and `make_intrinsics_np`
    give the JAX package's vectors exactly, defaults and every field set
    (more distortion terms than slots: the extra ones are dropped)."""
    kw = dict(focal_length=700.0, aspect_ratio=1.1, skew=0.3, principal_point=(10.0, 20.0),
              distortion=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6))
    np.testing.assert_array_equal(tintr.default_intrinsics(model).numpy(),
                                  np.asarray(jintr.default_intrinsics(model)))
    assert tintr.default_intrinsics(model).dtype == torch.float32
    for args in ({}, kw):
        np.testing.assert_array_equal(
            tintr.make_intrinsics(model, dtype=torch.float64, **args).numpy(),
            np.asarray(jintr.make_intrinsics(model, dtype=jnp.float64, **args)))
        np.testing.assert_array_equal(tintr.make_intrinsics_np(model, **args),
                                      jintr.make_intrinsics_np(model, **args))
    params = tintr.make_intrinsics_np(model, **kw)
    np.testing.assert_array_equal(
        tintr.principal_point(_t(params), model).numpy(),
        np.asarray(jintr.principal_point(jnp.asarray(params), model)))
    assert tintr.NUM_INTRINSICS[model] == jintr.NUM_INTRINSICS[jintr.CameraIntrinsicsModelType(model)]


@pytest.mark.parametrize("model", list(M), ids=[m.name for m in M])
def test_intrinsics_subset_mask_matches_jax(model):
    """BA's free columns: the mask of every one of the 64 flag sets equals
    the JAX package's."""
    for flags in range(64):
        np.testing.assert_array_equal(
            tintr.intrinsics_subset_mask(model, tintr.OptimizeIntrinsicsType(flags)),
            jintr.intrinsics_subset_mask(jintr.CameraIntrinsicsModelType(model),
                                         jintr.OptimizeIntrinsicsType(flags)),
            err_msg=f"flags {flags:#x}")


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


def _near_pi(aa, tol=1e-6):
    return np.abs(np.linalg.norm(aa, axis=-1) - np.pi) < tol


def test_camera_utility_functions_match_jax(rng):
    """The six camera utilities of `models/camera.py`, port against JAX in
    f64 to 1e-12 on a batch of [8, 8] extrinsics: the rotation matrix, the
    normalized and unit-depth rays of a PINHOLE_RADIAL_TANGENTIAL camera,
    the projection matrix and its decomposition. Near a rotation of pi
    either sign of the axis is right, so those angle-axes are compared as
    matrices."""
    aa = _rotations(rng).reshape(8, 8, 3)
    pos = rng.normal(size=(8, 8, 3)) * 3.0
    ext = np.concatenate([pos, aa], -1)
    text, jext = _t(ext), jnp.asarray(ext)
    np.testing.assert_allclose(tcam.rotation_matrix(text).numpy(),
                               np.asarray(jcam.rotation_matrix(jext)), rtol=0, atol=1e-12)

    model = M.PINHOLE_RADIAL_TANGENTIAL
    params = np.asarray(_params(model, (0.01, 0.001, 0.0001, 0.001, 0.0005)))
    pixels = rng.uniform(100, 900, (8, 8, 2))
    np.testing.assert_allclose(
        tcam.pixel_to_normalized(_t(params), _t(pixels), model).numpy(),
        np.asarray(jcam.pixel_to_normalized(jnp.asarray(params), jnp.asarray(pixels), model)),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tcam.pixel_to_unit_depth_ray(text, _t(params), _t(pixels), model).numpy(),
        np.asarray(jcam.pixel_to_unit_depth_ray(jext, jnp.asarray(params),
                                                jnp.asarray(pixels), model)),
        rtol=0, atol=1e-12)

    P = tcam.compose_projection_matrix(text)
    jP = np.array(jcam.compose_projection_matrix(jext))
    assert P.shape == (8, 8, 3, 4)
    np.testing.assert_allclose(P.numpy(), jP, rtol=0, atol=1e-12)
    aa_t, c_t = tcam.decompose_projection_matrix(_t(jP))
    aa_j, c_j = jcam.decompose_projection_matrix(jnp.asarray(jP))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-12)
    aa_t, aa_j = aa_t.numpy(), np.asarray(aa_j)
    far = ~_near_pi(aa_j)
    np.testing.assert_allclose(aa_t[far], aa_j[far], rtol=0, atol=1e-12)
    np.testing.assert_allclose(trnp.angle_axis_to_rotation_matrix_np(aa_t[~far]),
                               jrnp.angle_axis_to_rotation_matrix_np(aa_j[~far]),
                               rtol=0, atol=1e-12)
    ext_t = tcam.camera_from_projection_matrix(_t(jP)).numpy()
    ext_j = np.asarray(jcam.camera_from_projection_matrix(jnp.asarray(jP)))
    assert ext_t.shape == (8, 8, 6)
    np.testing.assert_allclose(ext_t[..., :3], ext_j[..., :3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(ext_t[far][:, 3:], ext_j[far][:, 3:], rtol=0, atol=1e-12)


def test_pixel_to_unit_depth_ray_roundtrip():
    """`tests/test_camera_models.py`'s round trip on the port: a point at
    depth 4 along the ray of a pixel projects back to it."""
    rng = np.random.default_rng(5)
    pos = _t(rng.normal(size=(3,)))
    aa = _t(0.3 * rng.normal(size=(3,)))
    ext = tcam.make_extrinsics(pos, aa)
    params = _t(_params(M.PINHOLE, (0.01, 0.001)))
    point = pos + tcam.pixel_to_unit_depth_ray(
        ext, params, _t([700.0, 500.0]), M.PINHOLE) * 4.0
    depth, pixel = tcam.project_point(ext, params, point, M.PINHOLE)
    np.testing.assert_allclose(float(depth), 4.0, atol=1e-8)
    np.testing.assert_allclose(pixel.numpy(), [700.0, 500.0], atol=1e-6)


def test_projection_matrix_roundtrip():
    """`tests/test_camera_models.py`'s round trip on the port, and in f32
    to 1e-5."""
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(6, 3))
    aa = 0.5 * rng.normal(size=(6, 3))
    ext = tcam.make_extrinsics(_t(pos), _t(aa))
    back = tcam.camera_from_projection_matrix(tcam.compose_projection_matrix(ext))
    np.testing.assert_allclose(back.numpy(), ext.numpy(), atol=1e-9)
    ext32 = ext.float()
    back32 = tcam.camera_from_projection_matrix(tcam.compose_projection_matrix(ext32))
    assert back32.dtype == torch.float32
    np.testing.assert_allclose(back32.numpy(), ext.numpy(), atol=1e-5)
