"""ECEF <-> geodetic (LLA) coordinate conversion on WGS-84.

Host-only numpy copy of the JAX package's `sfm/gps_converter.py`
(`theia/sfm/gps_converter.{h,cc}`, `gps_converter.h:61,66`), which implements Olson's closed-form method
(Olson, D.K., "Converting Earth-Centered, Earth-Fixed Coordinates to
Geodetic Coordinates", IEEE TAES 32(1), 1996). The reference converts one
point at a time with a branch on c^2 > 0.3; here both branches are computed
and selected with `where`, so the function is vectorized over [..., 3]
batches.

Latitude/longitude are degrees; altitude and ECEF are meters.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ecef_to_lla", "lla_to_ecef", "GPSConverter"]

# WGS-84 constants (same geodesy constants as the reference, gps_converter.cc:46-60).
_A = 6378137.0  # semi-major axis
_E2 = 6.6943799901377997e-3  # first eccentricity squared
_A1 = _A * _E2
_A2 = _A1 * _A1
_A3 = _A1 * _E2 / 2.0
_A4 = 2.5 * _A2
_A5 = _A1 + _A3
_A6 = 1.0 - _E2


def ecef_to_lla(ecef):
    """[..., 3] ECEF meters -> [..., 3] (lat deg, lon deg, alt m)."""
    ecef = np.asarray(ecef, np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    zp = np.abs(z)
    w2 = x * x + y * y
    w = np.sqrt(w2)
    r2 = w2 + z * z
    r = np.sqrt(r2)
    lon = np.arctan2(y, x)

    s2 = z * z / r2
    c2 = w2 / r2
    u = _A2 / r
    v = _A3 - _A4 / r

    # Branch 1 (c2 > 0.3): compute from sine; branch 2: from cosine.
    s_b1 = (zp / r) * (1.0 + c2 * (_A1 + u + s2 * v) / r)
    s_b1 = np.clip(s_b1, -1.0, 1.0)
    lat_b1 = np.arcsin(s_b1)
    c_b1 = np.sqrt(np.maximum(1.0 - s_b1 * s_b1, 0.0))

    c_b2 = (w / r) * (1.0 - s2 * (_A5 - u - c2 * v) / r)
    c_b2 = np.clip(c_b2, -1.0, 1.0)
    lat_b2 = np.arccos(c_b2)
    s_b2 = np.sqrt(np.maximum(1.0 - c_b2 * c_b2, 0.0))

    use1 = c2 > 0.3
    s = np.where(use1, s_b1, s_b2)
    c = np.where(use1, c_b1, c_b2)
    lat = np.where(use1, lat_b1, lat_b2)
    ss = s * s

    g = 1.0 - _E2 * ss
    rg = _A / np.sqrt(g)
    rf = _A6 * rg
    u = w - rg * c
    v = zp - rf * s
    f = c * u + s * v
    m = c * v - s * u
    p = m / (rf / g + f)
    lat = lat + p
    alt = f + m * p / 2.0
    lat = np.where(z < 0.0, -lat, lat)
    return np.stack([np.rad2deg(lat), np.rad2deg(lon), alt], axis=-1)


def lla_to_ecef(lla):
    """[..., 3] (lat deg, lon deg, alt m) -> [..., 3] ECEF meters."""
    lla = np.asarray(lla, np.float64)
    lat = np.deg2rad(lla[..., 0])
    lon = np.deg2rad(lla[..., 1])
    alt = lla[..., 2]
    sin_lat = np.sin(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * _A6 + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


class GPSConverter:
    """API-parity shim: `theia::GPSConverter` (`gps_converter.h:54-67`)."""

    ECEFToLLA = staticmethod(ecef_to_lla)
    LLAToECEF = staticmethod(lla_to_ecef)
