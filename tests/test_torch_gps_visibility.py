"""The port's `sfm/gps_converter.py` and `sfm/visibility_pyramid.py`
against the JAX package's, on numpy-seeded inputs.

GPS: `lla_to_ecef` / `ecef_to_lla` (and `GPSConverter`'s two static
methods) to 1e-9 on the inputs of `tests/test_aux_parity.py` (200 points,
latitudes to +-89.9 deg, altitudes -100 to 8,000 m) and on both poles and
the equator; the round trip at that test's bars. Visibility pyramid: the
score of `VisibilityPyramid` (point by point) and of `visibility_score`
equal to the JAX package's over image sizes, level counts and point sets
that include the image borders, points outside it (clipped into the edge
cells) and no point at all.
"""

import numpy as np
import pytest

from pytheiasfm_tpu.sfm import gps_converter as jgps
from pytheiasfm_tpu.sfm import visibility_pyramid as jvp
from pytheiasfm_tpu_torch.sfm import gps_converter as tgps
from pytheiasfm_tpu_torch.sfm import visibility_pyramid as tvp


def _lla(rng, n=200):
    lla = np.stack([rng.uniform(-89.9, 89.9, n), rng.uniform(-180, 180, n),
                    rng.uniform(-100, 8000, n)], -1)
    extra = [[90.0, 0.0, 0.0], [-90.0, 45.0, 10.0], [0.0, 0.0, 0.0], [0.0, 180.0, 8000.0],
             [45.0, -90.0, -100.0]]
    return np.concatenate([lla, extra])


def test_lla_to_ecef_and_back_match_jax():
    lla = _lla(np.random.default_rng(0))
    ecef = tgps.lla_to_ecef(lla)
    np.testing.assert_allclose(ecef, np.asarray(jgps.lla_to_ecef(lla)), rtol=1e-15, atol=1e-9)
    np.testing.assert_array_equal(tgps.GPSConverter.LLAToECEF(lla), ecef)
    back = tgps.ecef_to_lla(ecef)
    np.testing.assert_allclose(back, np.asarray(jgps.ecef_to_lla(ecef)), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tgps.GPSConverter.ECEFToLLA(ecef), back)
    # `tests/test_aux_parity.py`'s round-trip bars, away from the poles'
    # undefined longitude.
    body = slice(0, 200)
    assert np.max(np.abs(back[body, :2] - lla[body, :2])) < 1e-9
    assert np.max(np.abs(back[:, 2] - lla[:, 2])) < 1e-6
    assert tgps.lla_to_ecef(lla[0]).shape == (3,)


@pytest.mark.parametrize("width,height,levels,n", [
    (1024, 768, 6, 0), (1024, 768, 6, 1), (1024, 768, 6, 300), (640, 480, 4, 60),
    (1920, 1080, 8, 2000), (33, 17, 3, 25), (1000, 1000, 1, 10)])
def test_visibility_pyramid_scores_match_jax(width, height, levels, n):
    rng = np.random.default_rng(width + 7 * levels + n)
    points = rng.uniform([-20, -20], [width + 20, height + 20], (n, 2))
    if n >= 4:
        points[:4] = [[0, 0], [width, height], [width - 1e-9, 0], [0, height - 1e-9]]
    tpyr = tvp.VisibilityPyramid(width, height, levels)
    jpyr = jvp.VisibilityPyramid(width, height, levels)
    scores = []
    for k, p in enumerate(points):
        tpyr.add_point(p)
        jpyr.add_point(p)
        if k % 7 == 0:
            scores.append((tpyr.compute_score(), jpyr.compute_score()))
    scores.append((tpyr.compute_score(), jpyr.compute_score()))
    assert [t for t, _ in scores] == [j for _, j in scores]
    want = jvp.visibility_score(points, width, height, levels)
    assert tvp.visibility_score(points, width, height, levels) == want == scores[-1][1]
    assert 0 <= want <= sum(4 ** (lv + 1) for lv in range(levels))
