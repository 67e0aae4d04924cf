"""EXIF metadata -> CameraIntrinsicsPrior, with a camera sensor-width DB.

Host-only copy of the JAX package's `sfm/exif_reader.py` (it computes
nothing on a device). Parity target: `theia/sfm/exif_reader.h:49` plus the
bundled sensor database `data/camera_sensor_database.txt` (3,619 entries,
`make;model;sensor_width_mm` per line). The pyTheia fork stubs the C++
extraction out and tells users to populate priors from Python
(`exif_reader.h:47-57`); this module is that Python path, built on Pillow
(imported when a file is read, so the module imports without it):

  focal-length priority (original TheiaSfM semantics):
    1. FocalLengthIn35mmFilm: f_px = max_dim * f35 / 36.0 (35mm frame width)
    2. FocalLength (mm) + sensor width from the DB keyed on Make/Model:
       f_px = max_dim * f_mm / sensor_width_mm
    3. FocalPlaneXResolution + unit: f_px = f_mm * x_resolution / unit_in_mm
  GPS latitude/longitude/altitude populate the prior's geodetic fields
  (convertible to ECEF via `gps_converter`).
"""

from __future__ import annotations

import os

import numpy as np

from .reconstruction import CameraIntrinsicsPrior

__all__ = ["CameraSensorDatabase", "ExifReader", "DEFAULT_SENSOR_WIDTHS"]

# Built-in subset of well-known sensor widths (mm). The full reference DB can
# be loaded with CameraSensorDatabase.load(path) — same line format.
DEFAULT_SENSOR_WIDTHS = {
    "apple iphone 4": 4.54,
    "apple iphone 4s": 4.54,
    "apple iphone 5": 4.54,
    "apple iphone 6": 4.80,
    "apple iphone 7": 4.80,
    "apple iphone 8": 4.80,
    "canon eos 5d": 35.8,
    "canon eos 5d mark ii": 36.0,
    "canon eos 5d mark iii": 36.0,
    "canon eos 6d": 35.8,
    "canon eos 7d": 22.3,
    "canon eos 20d": 22.5,
    "canon eos 30d": 22.5,
    "canon eos 40d": 22.2,
    "canon eos 50d": 22.3,
    "canon eos 60d": 22.3,
    "canon eos 350d digital": 22.2,
    "canon eos 400d digital": 22.2,
    "canon eos 450d": 22.2,
    "canon eos 550d": 22.3,
    "canon eos 600d": 22.3,
    "canon eos digital rebel xt": 22.2,
    "canon eos digital rebel xti": 22.2,
    "canon powershot g9": 7.6,
    "canon powershot g10": 7.6,
    "canon powershot g11": 7.6,
    "canon powershot g12": 7.6,
    "canon powershot s95": 7.6,
    "canon powershot sx100 is": 5.75,
    "fujifilm x100": 23.6,
    "fujifilm x-t1": 23.6,
    "nikon d40": 23.7,
    "nikon d60": 23.6,
    "nikon d70": 23.7,
    "nikon d80": 23.6,
    "nikon d90": 23.6,
    "nikon d200": 23.6,
    "nikon d300": 23.6,
    "nikon d700": 36.0,
    "nikon d750": 35.9,
    "nikon d800": 35.9,
    "nikon d3100": 23.1,
    "nikon d5100": 23.6,
    "nikon d7000": 23.6,
    "olympus e-m5": 17.3,
    "panasonic dmc-gf1": 17.3,
    "panasonic dmc-lx3": 8.07,
    "pentax k-5": 23.7,
    "samsung gt-i9100": 4.54,
    "sony dsc-rx100": 13.2,
    "sony ilce-7": 35.8,
    "sony ilce-7r": 35.9,
    "sony nex-5": 23.4,
    "sony nex-7": 23.5,
    "sony slt-a55v": 23.5,
}


class CameraSensorDatabase:
    """Sensor-width lookup keyed on lowercase 'make model' (or bare model).

    Parses the reference's `camera_sensor_database.txt` format:
    `Make;Model;sensor_width_mm` one entry per line.
    """

    def __init__(self, widths: dict[str, float] | None = None):
        self.widths = dict(DEFAULT_SENSOR_WIDTHS if widths is None else widths)

    @classmethod
    def load(cls, path: str) -> "CameraSensorDatabase":
        widths = dict(DEFAULT_SENSOR_WIDTHS)
        with open(path, "r", errors="replace") as f:
            for line in f:
                parts = line.strip().split(";")
                if len(parts) != 3:
                    continue
                make, model, width = parts
                try:
                    w = float(width)
                except ValueError:
                    continue
                model_l = model.strip().lower()
                make_l = make.strip().lower()
                widths[model_l] = w
                if not model_l.startswith(make_l):
                    widths[f"{make_l} {model_l}"] = w
        return cls(widths)

    def sensor_width_mm(self, make: str, model: str) -> float | None:
        make_l = (make or "").strip().lower()
        model_l = (model or "").strip().lower()
        for key in (model_l, f"{make_l} {model_l}".strip()):
            if key and key in self.widths:
                return self.widths[key]
        return None


def _ratio(value) -> float | None:
    try:
        return float(value)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def _dms_to_degrees(dms, ref) -> float | None:
    try:
        deg = float(dms[0]) + float(dms[1]) / 60.0 + float(dms[2]) / 3600.0
    except (TypeError, IndexError, ValueError, ZeroDivisionError):
        return None
    if ref in ("S", "W"):
        deg = -deg
    return deg


class ExifReader:
    """EXIF -> CameraIntrinsicsPrior. Parity surface:
    `theia::ExifReader::ExtractEXIFMetadata` (`exif_reader.h:56`), with the
    extraction the pyTheia fork delegates to Python actually implemented."""

    def __init__(self, sensor_db: CameraSensorDatabase | None = None):
        self.sensor_db = sensor_db or CameraSensorDatabase()

    def extract_exif_metadata(
        self, image_file: str
    ) -> CameraIntrinsicsPrior | None:
        """Returns a prior (image size always set; focal/GPS when EXIF allows)
        or None when the file cannot be opened."""
        from PIL import ExifTags, Image

        if not os.path.exists(image_file):
            return None
        try:
            with Image.open(image_file) as img:
                width, height = img.size
                exif = img.getexif()
                try:
                    exif_ifd = exif.get_ifd(ExifTags.IFD.Exif)
                except Exception:
                    exif_ifd = {}
                try:
                    gps_ifd = exif.get_ifd(ExifTags.IFD.GPSInfo)
                except Exception:
                    gps_ifd = {}
        except Exception:
            return None

        prior = CameraIntrinsicsPrior(
            image_width=width,
            image_height=height,
            principal_point=(width / 2.0, height / 2.0),
        )
        max_dim = float(max(width, height))

        def tag(d, t):
            return d.get(int(t))

        B = ExifTags.Base
        f35 = _ratio(tag(exif_ifd, B.FocalLengthIn35mmFilm))
        f_mm = _ratio(tag(exif_ifd, B.FocalLength))
        make = exif.get(int(B.Make)) or ""
        model = exif.get(int(B.Model)) or ""

        focal_px = None
        if f35 and f35 > 0:
            focal_px = max_dim * f35 / 36.0
        elif f_mm and f_mm > 0:
            sw = self.sensor_db.sensor_width_mm(str(make), str(model))
            if sw:
                focal_px = max_dim * f_mm / sw
            else:
                # FocalPlaneXResolution fallback: resolution is px per unit.
                xres = _ratio(tag(exif_ifd, B.FocalPlaneXResolution))
                unit = tag(exif_ifd, B.FocalPlaneResolutionUnit)
                unit_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(unit)
                if xres and unit_mm:
                    focal_px = f_mm * xres / unit_mm
        if focal_px and focal_px > 0:
            prior.focal_length = float(focal_px)

        if gps_ifd:
            G = ExifTags.GPS
            lat = _dms_to_degrees(
                tag(gps_ifd, G.GPSLatitude), tag(gps_ifd, G.GPSLatitudeRef)
            )
            lon = _dms_to_degrees(
                tag(gps_ifd, G.GPSLongitude), tag(gps_ifd, G.GPSLongitudeRef)
            )
            alt = _ratio(tag(gps_ifd, G.GPSAltitude))
            if alt is not None and tag(gps_ifd, G.GPSAltitudeRef) in (1, b"\x01"):
                alt = -alt
            if lat is not None and lon is not None:
                prior.latitude = lat
                prior.longitude = lon
                prior.altitude = alt if alt is not None else 0.0
        return prior

    # Reference-style alias.
    ExtractEXIFMetadata = extract_exif_metadata


def set_position_priors_from_gps(recon, information_scale: float = 1.0):
    """Convert per-view GPS (lat/lon/alt) priors to ECEF position priors,
    recentred on the first view (parity with the reference's GPS-fusion use
    of `View::SetPositionPrior`, `view.h:95-112`)."""
    from .gps_converter import lla_to_ecef

    llas, vids = [], []
    for v in range(recon.num_views()):
        p = recon.view_priors[v]
        if p.latitude is not None and p.longitude is not None:
            llas.append([p.latitude, p.longitude, p.altitude or 0.0])
            vids.append(v)
    if not llas:
        return 0
    ecef = np.asarray(lla_to_ecef(np.asarray(llas, np.float64)))
    origin = ecef[0]
    sqrt_info = np.eye(3) * information_scale
    for v, pos in zip(vids, ecef - origin):
        recon.view_priors[v].position = pos
        recon.view_priors[v].position_sqrt_information = sqrt_info
    return len(vids)
