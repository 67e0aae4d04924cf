"""Theia ``.recon`` (cereal portable-binary) reader/writer.

Counterpart of the JAX package's `io/theia_recon.py`: `theia::ReadReconstruction`
/ `WriteReconstruction` (`io/reconstruction_reader.cc:38,71`,
`io/reconstruction_writer.cc:38,72`) and `ReadViewGraph` / `WriteViewGraph`,
a codec for cereal's ``PortableBinaryArchive`` of the reference's object
graph, so that the reference's fixtures (`data/sfm/fountain11.bin`,
`gt_fountain11.bin`) load and our reconstructions export back.

Wire format (cereal 1.x portable binary, little-endian):
  - archive header: 1 byte endianness flag (1 = little endian)
  - versioned types: a uint32 class version, written once per archive just
    before the first instance of each type
  - std::string / std::vector: uint64 size + payload; maps: uint64 size +
    (key, value) entries
  - Eigen matrices (`io/eigen_serializable.h`): int32 rows, int32 cols, then
    the column-major scalars
  - polymorphic std::shared_ptr: uint32 polymorphic id (0 = null; MSB set =
    a new type, followed by its registered name), then a uint32 pointer id
    (MSB set = first occurrence, followed by the payload)

Object layouts follow the reference's ``serialize()`` bodies:
`Reconstruction` (`sfm/reconstruction.h:183`), `View` (`sfm/view.h:119`),
`Camera` v1 (`camera/camera.h:211`), `CameraIntrinsicsPrior` v4
(`sfm/camera_intrinsics_prior.h:118`), `Feature` (`sfm/feature.h:110`),
`Track` (`sfm/track.h:95`), `ViewGraph` (`view_graph/view_graph.h:129`),
`TwoViewInfo` v1 (`sfm/twoview_info.h:133`).

Two dialects, told apart by parsing the modern one and requiring the
archive to end exactly where it does:
  - "modern": the current pyTheia ``serialize()`` bodies above;
  - "legacy": the layout of the shipped fixtures (written before the
    timestamp / prior / inverse-depth additions): no
    ``view_timestamp_to_id_``; View is (name, is_estimated, Camera,
    CameraIntrinsicsPrior, features) without the reverse feature map or pose
    priors; Feature is a bare Vector2d; Track is (is_estimated, view_ids,
    point, color).

The writer emits the JAX writer's bytes; its feature maps and track records
are packed a view or a whole table at a time as numpy records.
"""

from __future__ import annotations

import struct

import numpy as np

from ..models.intrinsics import NUM_INTRINSICS, CameraIntrinsicsModelType
from ..sfm.reconstruction import CameraIntrinsicsPrior, Reconstruction
from ..sfm.view_graph import TwoViewInfo, ViewGraph

__all__ = [
    "read_theia_reconstruction",
    "write_theia_reconstruction",
    "read_theia_view_graph",
    "write_theia_view_graph",
]

_MSB = 0x80000000
_MSB2 = 0x40000000

# cereal registered names (CEREAL_REGISTER_TYPE in camera/*.h) <-> model enum.
_MODEL_BY_NAME = {
    "theia::PinholeCameraModel": CameraIntrinsicsModelType.PINHOLE,
    "theia::PinholeRadialTangentialCameraModel": CameraIntrinsicsModelType.PINHOLE_RADIAL_TANGENTIAL,
    "theia::FisheyeCameraModel": CameraIntrinsicsModelType.FISHEYE,
    "theia::FOVCameraModel": CameraIntrinsicsModelType.FOV,
    "theia::DivisionUndistortionCameraModel": CameraIntrinsicsModelType.DIVISION_UNDISTORTION,
    "theia::DoubleSphereCameraModel": CameraIntrinsicsModelType.DOUBLE_SPHERE,
    "theia::ExtendedUnifiedCameraModel": CameraIntrinsicsModelType.EXTENDED_UNIFIED,
    "theia::OrthographicCameraModel": CameraIntrinsicsModelType.ORTHOGRAPHIC,
}
_NAME_BY_MODEL = {v: k for k, v in _MODEL_BY_NAME.items()}

# CameraIntrinsicsPrior.camera_intrinsics_model_type strings
# (camera_intrinsics_model_type.h:38-48).
_PRIOR_MODEL_STR = {m.name: m for m in _NAME_BY_MODEL}
_PRIOR_STR_BY_MODEL = {v: k for k, v in _PRIOR_MODEL_STR.items()}

# A feature-map entry after the one-time "Feature" version: the track id,
# Vector2d, Matrix2d (each with its rows / cols header), depth prior and its
# variance. Fixed-size, so a view's map packs and parses as one record array.
_FEAT_ENTRY = np.dtype([
    ("tid", "<u4"),
    ("r1", "<i4"), ("c1", "<i4"), ("pt", "<f8", (2,)),
    ("r2", "<i4"), ("c2", "<i4"), ("cov", "<f8", (4,)),
    ("depth", "<f8"), ("dvar", "<f8"),
])
_FEAT_ENTRY_LEGACY = np.dtype([("tid", "<u4"), ("r1", "<i4"), ("c1", "<i4"),
                               ("pt", "<f8", (2,))])
# The reverse map's entry: the feature first, then the track id.
_FEAT_REV = np.dtype([
    ("r1", "<i4"), ("c1", "<i4"), ("pt", "<f8", (2,)),
    ("r2", "<i4"), ("c2", "<i4"), ("cov", "<f8", (4,)),
    ("depth", "<f8"), ("dvar", "<f8"), ("tid", "<u4"),
])
# A modern track record after its view ids, up to the descriptor's payload:
# reference view, inverse depth, Vector4d point, Matrix<uint8,3,1> color,
# Vector3d bearing, and the (rows, cols) of the VectorXf descriptor.
_TRACK_TAIL = np.dtype([
    ("ref", "<u4"), ("inv_depth", "<f8"),
    ("pr", "<i4"), ("pc", "<i4"), ("point", "<f8", (4,)),
    ("cr", "<i4"), ("cc", "<i4"), ("color", "u1", (3,)),
    ("br", "<i4"), ("bc", "<i4"), ("bearing", "<f8", (3,)),
    ("dr", "<i4"), ("dc", "<i4"),
])
# A legacy track record after its view ids: point and color.
_TRACK_TAIL_LEGACY = np.dtype([
    ("pr", "<i4"), ("pc", "<i4"), ("point", "<f8", (4,)),
    ("cr", "<i4"), ("cc", "<i4"), ("color", "u1", (3,)),
])


# --------------------------------------------------------------------- reader


class _Reader:
    def __init__(self, data: bytes, legacy: bool = False):
        self.data = data
        self.off = 0
        self.legacy = legacy
        self.versions: dict[str, int] = {}
        self.poly_names: dict[int, str] = {}
        self.shared: dict[int, object] = {}

    # primitives ----------------------------------------------------------
    def raw(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("theia_recon: truncated archive")
        self.off += n
        return b

    def u8(self) -> int:
        return self.raw(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.raw(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def string(self) -> str:
        return self.raw(self.u64()).decode("utf-8", errors="replace")

    def doubles(self, n: int) -> np.ndarray:
        return np.frombuffer(self.raw(8 * n), "<f8").copy()

    def eigen(self, dtype="<f8") -> np.ndarray:
        rows, cols = self.i32(), self.i32()
        flat = np.frombuffer(self.raw(rows * cols * np.dtype(dtype).itemsize), dtype)
        # cereal saves Eigen's default (column-major) storage order.
        return flat.reshape((cols, rows)).T.copy()

    def version(self, type_key: str) -> int:
        if type_key not in self.versions:
            self.versions[type_key] = self.u32()
        return self.versions[type_key]

    # composite types ------------------------------------------------------
    def prior(self, n: int) -> tuple[bool, np.ndarray]:
        self.version(f"Prior<{n}>")
        is_set = self.boolean()
        return is_set, self.doubles(n)

    def intrinsics_prior(self) -> CameraIntrinsicsPrior:
        """Every version branch of the reference's serialize
        (`camera_intrinsics_prior.h:118-186`): v<=1 per-component Prior<1>
        focal / ppx / ppy / ..., v2 a Prior<2> radial, v3 adds the model
        string, v4 the Prior<2> principal point."""
        v = self.version("CameraIntrinsicsPrior")
        p = CameraIntrinsicsPrior()
        if v <= 1:
            if v >= 1:
                p.image_width = self.i32()
                p.image_height = self.i32()
            (set_f, f), (set_ppx, ppx), (set_ppy, ppy), (set_a, a), (set_s, s), \
                (set_r1, r1), (set_r2, r2) = (self.prior(1) for _ in range(7))
            if set_f:
                p.focal_length = float(f[0])
            if set_ppx and set_ppy:
                p.principal_point = (float(ppx[0]), float(ppy[0]))
            if set_a:
                p.aspect_ratio = float(a[0])
            if set_s:
                p.skew = float(s[0])
            if set_r1 and set_r2:
                p.radial_distortion = (float(r1[0]), float(r2[0]), 0.0, 0.0)
            return p
        p.image_width = self.i32()
        p.image_height = self.i32()
        if v >= 3:
            p.camera_intrinsics_model_type = _PRIOR_MODEL_STR.get(
                self.string(), CameraIntrinsicsModelType.PINHOLE)
        set_f, f = self.prior(1)
        if set_f:
            p.focal_length = float(f[0])
        if v >= 4:
            set_pp, pp = self.prior(2)
            if set_pp:
                p.principal_point = (float(pp[0]), float(pp[1]))
        set_a, a = self.prior(1)
        if set_a:
            p.aspect_ratio = float(a[0])
        set_s, s = self.prior(1)
        if set_s:
            p.skew = float(s[0])
        set_rd, rd = self.prior(4 if v >= 3 else 2)
        if set_rd:
            p.radial_distortion = tuple(float(x) for x in rd)
        set_td, td = self.prior(2)
        if set_td:
            p.tangential_distortion = tuple(float(x) for x in td)
        set_pos, pos = self.prior(3)
        if set_pos:
            p.position = pos.copy()
        set_ori, ori = self.prior(3)
        if set_ori:
            p.orientation = ori.copy()
        for name in ("latitude", "longitude", "altitude"):
            is_set, val = self.prior(1)
            if is_set:
                setattr(p, name, float(val[0]))
        return p

    def intrinsics_model(self):
        """Polymorphic shared_ptr<CameraIntrinsicsModel> -> (model_type,
        params), or the object an earlier pointer id decoded."""
        poly_id = self.u32()
        if poly_id == 0:
            return None
        if poly_id & _MSB:
            name = self.string()
            self.poly_names[poly_id & ~(_MSB | _MSB2)] = name
        else:
            name = self.poly_names[poly_id & ~(_MSB | _MSB2)]
        # ptr_wrapper (memory.hpp:262-271): tracking id, payload on first use.
        ptr_id = self.u32()
        if ptr_id == 0:
            return None
        key = ptr_id & ~_MSB
        if not ptr_id & _MSB:
            return self.shared[key]
        model = _MODEL_BY_NAME[name]
        self.version(name)  # derived class version
        self.version("CameraIntrinsicsModel")  # base subobject version
        params = self.doubles(self.u64())  # std::vector<double> parameters_
        self.shared[key] = (model, params)
        return self.shared[key]

    def camera(self):
        """-> (extrinsics [6], (model, params) or a shared one, image size [2])."""
        if self.version("Camera") > 0:
            ext = self.doubles(6)
            model = self.intrinsics_model()
        else:
            # v0: the 6 extrinsics and 7 pinhole parameters, then the image
            # size (camera.h:224-249); v0 archives share no pointers.
            params = self.doubles(13)
            ext = params[:6]
            model = (CameraIntrinsicsModelType.PINHOLE, params[6:])
        size = np.frombuffer(self.raw(8), "<i4").copy()
        return ext, model, size

    def feature(self):
        if self.legacy:
            # A legacy Feature is a bare Eigen::Vector2d.
            return self.eigen().ravel(), np.eye(2), 0.0, 0.0
        self.version("Feature")
        pt = self.eigen()  # Vector2d
        cov = self.eigen()  # Matrix2d
        return pt.ravel(), cov, self.f64(), self.f64()

    def _feature_map(self, n_feat: int):
        """-> (tids [N] i64, pts [N, 2], cov [N, 2, 2], depth [N], dvar [N])."""
        first = None
        # The first feature record of the archive carries the class version;
        # it goes through the one-record path, which reads it.
        if n_feat > 0 and not self.legacy and "Feature" not in self.versions:
            tid = self.u32()
            first = (tid, self.feature())
            n_feat -= 1
        ent = _FEAT_ENTRY_LEGACY if self.legacy else _FEAT_ENTRY
        rec = np.frombuffer(self.raw(ent.itemsize * n_feat), ent)
        if n_feat and not (
            (rec["r1"] == 2).all() and (rec["c1"] == 1).all()
            and (self.legacy or ((rec["r2"] == 2) & (rec["c2"] == 2)).all())
        ):
            raise ValueError("theia_recon: feature map shape headers mismatch")
        tids = rec["tid"].astype(np.int64)
        pts = rec["pt"].astype(np.float64).reshape(-1, 2)
        if self.legacy:
            cov = np.broadcast_to(np.eye(2), (n_feat, 2, 2))
            depth = np.zeros(n_feat)
            dvar = np.zeros(n_feat)
        else:
            # Column-major Matrix2d, symmetric.
            cov = rec["cov"].astype(np.float64).reshape(-1, 2, 2)
            depth = rec["depth"].astype(np.float64)
            dvar = rec["dvar"].astype(np.float64)
        if first is not None:
            ftid, (fpt, fcov, fd, fdv) = first
            tids = np.concatenate([[ftid], tids])
            pts = np.concatenate([fpt[None], pts])
            cov = np.concatenate([fcov[None], cov])
            depth = np.concatenate([[fd], depth])
            dvar = np.concatenate([[fdv], dvar])
        return tids, pts, cov, depth, dvar

    def view(self):
        self.version("View")
        name = self.string()
        timestamp = 0.0 if self.legacy else self.f64()
        is_estimated = self.boolean()
        cam = self.camera()
        prior = self.intrinsics_prior()
        features = self._feature_map(self.u64())
        if self.legacy:
            return name, timestamp, is_estimated, cam, prior, features
        # features_to_tracks_: the redundant reverse map, skipped whole (its
        # records are fixed-size once the Feature version is known).
        n_rev = self.u64()
        if n_rev and "Feature" not in self.versions:
            self.feature()
            self.u32()
            n_rev -= 1
        self.raw(_FEAT_REV.itemsize * n_rev)
        for field in ("position", "gravity", "orientation"):
            value = self.eigen().ravel()
            sqrt_info = self.eigen()
            if self.boolean():
                setattr(prior, field, value)
                setattr(prior, f"{field}_sqrt_information", sqrt_info)
        return name, timestamp, is_estimated, cam, prior, features

    def track(self):
        self.version("Track")
        is_estimated = self.boolean()
        view_ids = [self.u32() for _ in range(self.u64())]
        if self.legacy:
            point = self.eigen().ravel()  # Vector4d
            color = self.eigen("u1").ravel()  # Matrix<uint8,3,1>
            return is_estimated, view_ids, 0xFFFFFFFF, 0.0, point, color, np.zeros(3)
        reference_view_id = self.u32()
        inverse_depth = self.f64()
        point = self.eigen().ravel()
        color = self.eigen("u1").ravel()
        reference_bearing = self.eigen().ravel()
        self.eigen("<f4")  # reference_descriptor_: VectorXf (possibly 0x1)
        return (is_estimated, view_ids, reference_view_id, inverse_depth, point, color,
                reference_bearing)

    def _tracks_fast(self, n_tracks: int, legacy: bool):
        """`n_tracks` track records of either dialect in one loop of
        `struct.unpack_from` and record views. The first record of the
        archive goes through `track()`, which reads the class version. Each
        record's Eigen headers are checked, so an archive of another layout
        fails here with the record's index."""
        out = []
        if n_tracks > 0 and "Track" not in self.versions:
            tid0 = self.u32()
            out.append((tid0, self.track()))
            n_tracks -= 1
        tail = _TRACK_TAIL_LEGACY if legacy else _TRACK_TAIL
        first = len(out)
        data, off = self.data, self.off
        upk, fromb = struct.unpack_from, np.frombuffer
        for k in range(n_tracks):
            tid, is_est, n_views = upk("<IBQ", data, off)
            off += 13
            view_ids = fromb(data, "<u4", n_views, off).tolist()
            off += 4 * n_views
            if off + tail.itemsize > len(data):
                raise ValueError("theia_recon: truncated archive")
            rec = fromb(data, tail, 1, off)[0]
            off += tail.itemsize
            if (rec["pr"], rec["pc"], rec["cr"], rec["cc"]) != (4, 1, 3, 1) or (
                    not legacy and (rec["br"], rec["bc"], rec["dc"]) != (3, 1, 1)):
                raise ValueError(
                    f"theia_recon: track record {first + k} has Eigen headers "
                    f"{tuple(int(x) for x in (rec['pr'], rec['pc'], rec['cr'], rec['cc']))} "
                    "for its point and color, not (4, 1, 3, 1): not a "
                    f"{'legacy' if legacy else 'modern'}-dialect archive")
            point = rec["point"].astype(np.float64)
            color = rec["color"].copy()
            if legacy:
                out.append((tid, (is_est != 0, view_ids, 0xFFFFFFFF, 0.0, point, color,
                                  np.zeros(3))))
                continue
            off += 4 * int(rec["dr"])  # reference_descriptor_ payload
            out.append((tid, (is_est != 0, view_ids, int(rec["ref"]), float(rec["inv_depth"]),
                              point, color, rec["bearing"].astype(np.float64))))
        self.off = off
        return out

    def two_view_info(self) -> TwoViewInfo:
        v = self.version("TwoViewInfo")
        info = TwoViewInfo()
        info.focal_length_1 = self.f64()
        info.focal_length_2 = self.f64()
        info.position_2 = self.eigen().ravel()
        info.rotation_2 = self.eigen().ravel()
        info.num_verified_matches = self.i32()
        info.num_homography_inliers = self.i32()
        info.scale_estimate = self.f64()
        if v > 0:
            info.visibility_score = self.i32()
        return info


def _parse_reconstruction(data: bytes, legacy: bool):
    """Parse the archive into (views, tracks, view_to_group) keyed by the
    archive's ids. Raises on any structural mismatch, and unless the archive
    ends where the parse does."""
    r = _Reader(data, legacy=legacy)
    if r.u8() != 1:
        raise NotImplementedError("theia_recon: big-endian archives unsupported")
    r.version("Reconstruction")
    r.u32()  # next_track_id_
    r.u32()  # next_view_id_
    for _ in range(r.u64()):  # view_name_to_id_ (rebuilt from views_)
        r.string()
        r.u32()
    if not legacy:
        for _ in range(r.u64()):  # view_timestamp_to_id_
            r.f64()
            r.u32()
    views = {}
    for _ in range(r.u64()):
        vid = r.u32()
        views[vid] = r.view()
    tracks = dict(r._tracks_fast(r.u64(), legacy))
    view_to_group = {}
    for _ in range(r.u64()):
        vid = r.u32()
        view_to_group[vid] = r.u32()
    for _ in range(r.u64()):  # camera_intrinsics_groups_ (redundant)
        r.u32()
        for _ in range(r.u64()):
            r.u32()
    if r.off != len(data):
        raise ValueError(f"theia_recon: {len(data) - r.off} trailing bytes (wrong dialect?)")
    return views, tracks, view_to_group


def read_theia_reconstruction(path: str) -> Reconstruction:
    """Load a reference ``.recon`` / ``.bin`` file into the SoA container.

    Parity: `theia::ReadReconstruction` (`io/reconstruction_reader.cc:38-71`).
    View and track ids are remapped densely in ascending order of the
    archive's ids; names, priors, poses, points, colors and each view's
    features carry over. Tries the modern dialect, then the legacy one; an
    archive of neither raises the legacy parse's error.
    """
    with open(path, "rb") as f:
        data = f.read()
    try:
        views, tracks, view_to_group = _parse_reconstruction(data, legacy=False)
    except Exception:
        views, tracks, view_to_group = _parse_reconstruction(data, legacy=True)

    recon = Reconstruction()
    vid_map = {}
    group_map: dict[int, int] = {}
    for vid in sorted(views):
        name, timestamp, is_est, (ext, model, size), prior, _ = views[vid]
        if model is not None:
            model_type, params = model
            prior.camera_intrinsics_model_type = model_type
        if prior.image_width == 0 and size[0] > 0:
            prior.image_width, prior.image_height = int(size[0]), int(size[1])
        src_group = view_to_group.get(vid, vid)
        new_id = recon.add_view(name, group_id=group_map.get(src_group), timestamp=timestamp,
                                prior=prior)
        group_map.setdefault(src_group, int(recon.view_group[new_id]))
        vid_map[vid] = new_id
        recon.view_extrinsics[new_id] = ext
        recon.view_estimated[new_id] = is_est
        if model is not None:
            g = recon.view_group[new_id]
            n = min(len(params), recon.intrinsics.shape[1])
            recon.intrinsics[g, :] = 0.0
            recon.intrinsics[g, :n] = params[:n]
            recon.group_model[g] = model_type

    T = len(tracks)
    recon.points = np.zeros((T, 4), recon.dtype)
    recon.track_estimated = np.zeros((T,), bool)
    recon.track_colors = np.zeros((T, 3), np.uint8)
    recon.track_inverse_depth = np.zeros((T,), recon.dtype)
    recon.track_reference_view = np.full((T,), -1, np.int32)
    tid_map = {}
    for new_t, tid in enumerate(sorted(tracks)):
        is_est, _, ref_vid, inv_depth, point, color, _ = tracks[tid]
        recon.points[new_t] = point
        recon.track_estimated[new_t] = is_est
        recon.track_colors[new_t] = color
        recon.track_inverse_depth[new_t] = inv_depth
        if ref_vid in vid_map:
            recon.track_reference_view[new_t] = vid_map[ref_vid]
        tid_map[tid] = new_t

    # The observation table, a view at a time (rows sorted by track id).
    max_tid = max(tracks) if tracks else -1
    tid_arr = np.full(max_tid + 2, -1, np.int64)
    for tid, nt in tid_map.items():
        tid_arr[tid] = nt
    parts = {k: [] for k in ("view", "track", "uv", "sic", "dp", "dpv")}
    for vid in sorted(views):
        tids, pts, cov, depth, dvar = views[vid][5]
        order = np.argsort(tids, kind="stable")
        tids, pts, cov, depth, dvar = (a[order] for a in (tids, pts, cov, depth, dvar))
        known = (tids <= max_tid) & (tid_arr[np.minimum(tids, max_tid + 1)] >= 0)
        tids, pts, cov, depth, dvar = (a[known] for a in (tids, pts, cov, depth, dvar))
        parts["view"].append(np.full(len(tids), vid_map[vid], np.int32))
        parts["track"].append(tid_arr[tids].astype(np.int32))
        parts["uv"].append(pts)
        # The diagonal sqrt-inverse covariance the BA reads.
        parts["sic"].append(1.0 / np.sqrt(np.clip(cov[:, [0, 1], [0, 1]], 1e-12, None)))
        parts["dp"].append(depth)
        parts["dpv"].append(dvar)

    def cat(key, dtype):
        return np.concatenate(parts[key]).astype(dtype) if parts[key] else np.zeros((0,), dtype)

    recon.obs_view = cat("view", np.int32)
    recon.obs_track = cat("track", np.int32)
    O = len(recon.obs_view)
    recon.obs_uv = cat("uv", recon.dtype).reshape(O, 2)
    recon.obs_sqrt_inv_cov = cat("sic", recon.dtype).reshape(O, 2)
    recon.obs_depth_prior = cat("dp", recon.dtype)
    recon.obs_depth_prior_variance = cat("dpv", recon.dtype)
    # Rows grouped by track by one stable argsort.
    order = np.argsort(recon.obs_track, kind="stable")
    counts = np.bincount(recon.obs_track, minlength=T)
    bounds = np.zeros(T + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    recon._track_obs = [order[bounds[t]:bounds[t + 1]].tolist() for t in range(T)]
    # The first observing view (ascending view id) becomes the reference
    # view of a track that had none.
    need_ref = recon.track_reference_view < 0
    if need_ref.any() and O:
        first_row = order[bounds[:-1]]
        sel = need_ref & (counts > 0)
        recon.track_reference_view[sel] = recon.obs_view[np.where(counts > 0, first_row, 0)][sel]
    for row, (v, t) in enumerate(zip(recon.obs_view.tolist(), recon.obs_track.tolist())):
        recon._view_track_to_obs[v][t] = row
    return recon


def read_theia_view_graph(path: str) -> ViewGraph:
    """Parity: `theia::ReadViewGraph` (cereal archive of `ViewGraph`)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u8() != 1:
        raise NotImplementedError("theia_recon: big-endian archives unsupported")
    r.version("ViewGraph")
    for _ in range(r.u64()):  # vertices_ (redundant adjacency)
        r.u32()
        for _ in range(r.u64()):
            r.u32()
    graph = ViewGraph()
    for _ in range(r.u64()):
        v1, v2 = r.u32(), r.u32()
        graph.add_edge(v1, v2, r.two_view_info())
    return graph


# --------------------------------------------------------------------- writer


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []
        self.versions: set[str] = set()
        self.poly_ids: dict[str, int] = {}
        self.next_poly = 1
        self.shared_ids: dict[int, int] = {}
        self.next_ptr = 1

    def raw(self, b: bytes):
        self.parts.append(b)

    def u8(self, x):
        self.raw(struct.pack("<B", x))

    def u32(self, x):
        self.raw(struct.pack("<I", x))

    def i32(self, x):
        self.raw(struct.pack("<i", x))

    def u64(self, x):
        self.raw(struct.pack("<Q", x))

    def f64(self, x):
        self.raw(struct.pack("<d", float(x)))

    def boolean(self, x):
        self.u8(1 if x else 0)

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u64(len(b))
        self.raw(b)

    def doubles(self, arr):
        self.raw(np.ascontiguousarray(arr, "<f8").tobytes())

    def eigen(self, arr, dtype="<f8"):
        a = np.asarray(arr)
        if a.ndim == 1:
            a = a[:, None]
        self.i32(a.shape[0])
        self.i32(a.shape[1])
        self.raw(np.asfortranarray(a.astype(dtype)).tobytes(order="F"))

    def version(self, type_key: str, v: int):
        if type_key not in self.versions:
            self.versions.add(type_key)
            self.u32(v)

    def prior(self, n: int, values=None):
        self.version(f"Prior<{n}>", 0)
        self.boolean(values is not None)
        vals = np.zeros(n) if values is None else np.asarray(values, "<f8").ravel()
        out = np.zeros(n)
        out[:min(n, len(vals))] = vals[:min(n, len(vals))]
        self.doubles(out)

    def intrinsics_prior(self, p: CameraIntrinsicsPrior):
        self.version("CameraIntrinsicsPrior", 4)
        self.i32(p.image_width)
        self.i32(p.image_height)
        self.string(_PRIOR_STR_BY_MODEL[p.camera_intrinsics_model_type])
        self.prior(1, None if p.focal_length is None else [p.focal_length])
        self.prior(2, p.principal_point)
        self.prior(1, None if p.aspect_ratio is None else [p.aspect_ratio])
        self.prior(1, None if p.skew is None else [p.skew])
        self.prior(4, p.radial_distortion if p.radial_distortion else None)
        self.prior(2, p.tangential_distortion if p.tangential_distortion else None)
        self.prior(3, p.position)
        self.prior(3, p.orientation)
        self.prior(1, None if p.latitude is None else [p.latitude])
        self.prior(1, None if p.longitude is None else [p.longitude])
        self.prior(1, None if p.altitude is None else [p.altitude])

    def intrinsics_model(self, group_key: int, model: CameraIntrinsicsModelType, params):
        name = _NAME_BY_MODEL[model]
        if name in self.poly_ids:
            self.u32(self.poly_ids[name])
        else:
            pid = self.next_poly
            self.next_poly += 1
            self.poly_ids[name] = pid
            self.u32(pid | _MSB)
            self.string(name)
        if group_key in self.shared_ids:
            self.u32(self.shared_ids[group_key])
            return
        ptr_id = self.next_ptr
        self.next_ptr += 1
        self.shared_ids[group_key] = ptr_id
        self.u32(ptr_id | _MSB)
        self.version(name, 1)
        self.version("CameraIntrinsicsModel", 0)
        n = NUM_INTRINSICS[model]
        self.u64(n)
        self.doubles(np.asarray(params)[:n])

    def feature(self, uv, cov_diag):
        self.version("Feature", 0)
        self.eigen(np.asarray(uv, "<f8"))
        self.eigen(np.diag(cov_diag))
        self.f64(0.0)
        self.f64(0.0)

    def feature_maps(self, tids, uv, sqrt_inv_cov):
        """A view's feature map and its reverse map (`features_to_tracks_`)
        in the record layouts `_FEAT_ENTRY` / `_FEAT_REV`: the diagonal
        sqrt-information turned back into a covariance, no depth prior."""
        n = len(tids)
        uv = np.asarray(uv, "<f8").reshape(n, 2)
        cov = 1.0 / np.clip(np.asarray(sqrt_inv_cov, "<f8").reshape(n, 2), 1e-12, None) ** 2
        self.u64(n)
        first = 0
        if n and "Feature" not in self.versions:
            self.u32(int(tids[0]))
            self.feature(uv[0], cov[0])
            first = 1
        records = []
        for dtype in (_FEAT_ENTRY, _FEAT_REV):
            rec = np.zeros(n, dtype)
            rec["tid"] = tids
            rec["r1"], rec["c1"], rec["r2"], rec["c2"] = 2, 1, 2, 2
            rec["pt"] = uv
            rec["cov"][:, 0] = cov[:, 0]
            rec["cov"][:, 3] = cov[:, 1]
            records.append(rec)
        self.raw(records[0][first:].tobytes())
        self.u64(n)
        self.raw(records[1].tobytes())

    def two_view_info(self, info: TwoViewInfo):
        self.version("TwoViewInfo", 1)
        self.f64(info.focal_length_1)
        self.f64(info.focal_length_2)
        self.eigen(np.asarray(info.position_2, "<f8"))
        self.eigen(np.asarray(info.rotation_2, "<f8"))
        self.i32(int(info.num_verified_matches))
        self.i32(int(info.num_homography_inliers))
        self.f64(info.scale_estimate)
        self.i32(int(getattr(info, "visibility_score", 0)))

    def tobytes(self) -> bytes:
        return b"".join(self.parts)


def _pose_prior(w: _Writer, value, sqrt_info):
    w.eigen(value if value is not None else np.zeros(3))
    w.eigen(sqrt_info if sqrt_info is not None else np.eye(3))
    w.boolean(value is not None)


def _tracks(w: _Writer, recon: Reconstruction):
    """Every track record: (id, version once, is_estimated, the observing
    views, reference view, inverse depth, point, color, a zero bearing, an
    empty descriptor), the fixed parts packed as one record array."""
    T = recon.num_tracks()
    w.u64(T)
    if not T:
        return
    rows = [recon.track_observations(t) for t in range(T)]
    counts = np.fromiter(map(len, rows), np.int64, T)
    views = recon.obs_view[np.concatenate(rows).astype(np.int64)] if counts.sum() else (
        np.zeros(0, np.int64))
    view_bytes = views.astype("<u4").tobytes()
    ends = 4 * np.cumsum(counts)
    head = np.zeros(T, [("tid", "<u4"), ("est", "u1"), ("n", "<u8")])
    head["tid"] = np.arange(T)
    head["est"] = recon.track_estimated
    head["n"] = counts
    tail = np.zeros(T, _TRACK_TAIL)
    tail["ref"] = recon.track_reference_view.astype(np.int64) & 0xFFFFFFFF
    tail["inv_depth"] = recon.track_inverse_depth
    tail["pr"], tail["pc"], tail["cr"], tail["cc"] = 4, 1, 3, 1
    tail["br"], tail["bc"], tail["dr"], tail["dc"] = 3, 1, 0, 1
    tail["point"] = np.asarray(recon.points, "<f8")
    tail["color"] = recon.track_colors
    hb, tb = head.tobytes(), tail.tobytes()
    hs, ts = head.itemsize, tail.itemsize
    out = []
    for t in range(T):
        h = hb[t * hs:(t + 1) * hs]
        if t == 0 and "Track" not in w.versions:
            w.versions.add("Track")
            h = h[:4] + struct.pack("<I", 0) + h[4:]
        out += (h, view_bytes[ends[t] - 4 * counts[t]:ends[t]], tb[t * ts:(t + 1) * ts])
    w.raw(b"".join(out))


def write_theia_reconstruction(recon: Reconstruction, path: str) -> None:
    """Write the container as a reference-compatible ``.recon`` archive,
    the JAX writer's bytes.

    Parity: `theia::WriteReconstruction` (`io/reconstruction_writer.cc:38-72`).
    """
    w = _Writer()
    w.u8(1)  # little-endian header
    w.version("Reconstruction", 0)
    V, T = recon.num_views(), recon.num_tracks()
    w.u32(T)  # next_track_id_
    w.u32(V)  # next_view_id_
    w.u64(V)
    for v in range(V):
        w.string(recon.view_names[v])
        w.u32(v)
    w.u64(V)
    for v in range(V):
        w.f64(recon.view_timestamps[v])
        w.u32(v)
    w.u64(V)
    for v in range(V):
        w.u32(v)
        w.version("View", 0)
        w.string(recon.view_names[v])
        w.f64(recon.view_timestamps[v])
        w.boolean(bool(recon.view_estimated[v]))
        w.version("Camera", 1)
        w.doubles(recon.view_extrinsics[v])
        g = int(recon.view_group[v])
        w.intrinsics_model(g, recon.group_model[g], recon.intrinsics[g])
        prior = recon.view_priors[v]
        w.raw(struct.pack("<2i", prior.image_width, prior.image_height))
        w.intrinsics_prior(prior)
        obs = recon._view_track_to_obs[v]
        rows = np.fromiter(obs.values(), np.int64, len(obs))
        w.feature_maps(np.fromiter(obs.keys(), np.int64, len(obs)), recon.obs_uv[rows],
                       recon.obs_sqrt_inv_cov[rows])
        _pose_prior(w, prior.position, prior.position_sqrt_information)
        _pose_prior(w, prior.gravity, prior.gravity_sqrt_information)
        _pose_prior(w, prior.orientation, prior.orientation_sqrt_information)
    _tracks(w, recon)
    w.u64(V)
    for v in range(V):
        w.u32(v)
        w.u32(int(recon.view_group[v]))
    groups: dict[int, list[int]] = {}
    for v in range(V):
        groups.setdefault(int(recon.view_group[v]), []).append(v)
    w.u64(len(groups))
    for g, members in groups.items():
        w.u32(g)
        w.u64(len(members))
        for v in members:
            w.u32(v)
    with open(path, "wb") as f:
        f.write(w.tobytes())


def write_theia_view_graph(graph: ViewGraph, path: str) -> None:
    """Parity: `theia::WriteViewGraph`."""
    w = _Writer()
    w.u8(1)
    w.version("ViewGraph", 0)
    adjacency: dict[int, set[int]] = {}
    for (v1, v2) in graph.edges:
        adjacency.setdefault(v1, set()).add(v2)
        adjacency.setdefault(v2, set()).add(v1)
    w.u64(len(adjacency))
    for v, nbrs in adjacency.items():
        w.u32(v)
        w.u64(len(nbrs))
        for n in nbrs:
            w.u32(n)
    w.u64(len(graph.edges))
    for (v1, v2), info in graph.edges.items():
        w.u32(v1)
        w.u32(v2)
        w.two_view_info(info)
    with open(path, "wb") as f:
        f.write(w.tobytes())
